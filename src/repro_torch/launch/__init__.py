"""Launchers of the port: `serve` (batched LM generation, optionally
RAG-augmented by the port's OctopusANN index)."""
