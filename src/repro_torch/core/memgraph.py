"""MemGraph (§4.1.3): a memory-resident navigation graph over a random sample
of the base vectors. Queries first search the sampled graph (pure compute, no
page I/O), and the best hits become high-quality entry points for the
disk-resident search — shortening convergence paths (Finding 3).

The port of src/repro/core/memgraph.py; the navigation search is the port's
`beam_search_mem`, on the MemGraph's device. The MemGraph uploads its vectors
and graph once and keeps them there, so it also keeps the navigation hops
captured over them in `graphs` (on the card, one CUDA graph a batch size,
replayed every iteration of every call of that size; core/hop_loop.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import vamana
from repro_torch.core.hop_loop import HopGraphs


@dataclasses.dataclass
class MemGraph:
    sample_ids: np.ndarray   # (s,) int32 — vids of sampled vertices
    vectors: np.ndarray      # (s, d) float32 (memory-resident)
    graph: np.ndarray        # (s, R') int32
    medoid: int              # index into the sample
    build_s: float
    device: torch.device     # where the navigation search runs
    _dev: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                              compare=False)
    graphs: HopGraphs = dataclasses.field(
        default_factory=HopGraphs, repr=False, compare=False)

    @property
    def memory_bytes(self) -> int:
        # topology + sample ids only is the paper's accounting for MemGraph;
        # we also keep sampled vectors resident (navigation needs them)
        return self.graph.nbytes + self.sample_ids.nbytes + self.vectors.nbytes

    def _device_arrays(self) -> tuple:
        if self._dev is None:
            self._dev = (
                torch.as_tensor(self.vectors, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(self.graph.astype(np.int64),
                                device=self.device))
        return self._dev

    def entry_points(self, queries: np.ndarray, n_entries: int = 4,
                     L: int = 32, width: int = 2, tracer=None) -> dict:
        """Returns dict(entries (B, n_entries) int32 vids in the FULL id
        space, hops (B,), dist_evals per query). A host-clock `tracer`
        gets the navigation search's spans (vamana.beam_search_mem)."""
        X, G = self._device_arrays()
        res = vamana.beam_search_mem(X, G, self.medoid, queries, L=L,
                                     width=width, device=self.device,
                                     graphs=self.graphs, tracer=tracer)
        ids = res["ids"][:, :n_entries]
        valid = ids < self.vectors.shape[0]
        entries = np.where(valid, self.sample_ids[np.minimum(
            np.maximum(ids, 0), len(self.sample_ids) - 1)], -1)
        hops = res["hops"].astype(np.int32)
        # distance evaluations in memory: hops * width * R'
        evals = hops * width * self.graph.shape[1]
        return {"entries": entries.astype(np.int32), "hops": hops,
                "dist_evals": evals}


def build_memgraph(vectors: np.ndarray, frac: float = 0.01, R: int = 48,
                   L: int = 64, seed: int = 0, device=None) -> MemGraph:
    device = resolve_device(device)
    n = vectors.shape[0]
    s = max(64, int(round(frac * n)))
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(n, s, replace=False)).astype(np.int32)
    sub = vectors[ids].astype(np.float32)
    g, med, stats = vamana.build_vamana(sub, R=min(R, s - 1), L=min(L, s),
                                        alpha=1.2, seed=seed,
                                        batch=min(1024, s), device=device)
    return MemGraph(sample_ids=ids, vectors=sub, graph=g, medoid=med,
                    build_s=stats["build_s"], device=device)
