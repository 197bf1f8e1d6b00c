"""Launchers of the port: `serve` (batched LM generation, optionally
RAG-augmented by the port's OctopusANN index), `train`, and `mesh` (the
mesh factories and `run_in_processes`)."""
