"""Deterministic synthetic token pipeline, host-sharded.

Every batch is a pure function of (seed, host, step): restarts resume exactly
(no data-order drift after a failure), hosts never overlap shards, and a
straggling host can be re-assigned a shard deterministically. Zipf-ish token
marginals + an order-2 mixing process give non-trivial learnable structure so
example training losses actually fall.

A copy of src/repro/data/pipeline.py (numpy only): the same (seed, host,
step) gives the same batch in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random bigram mixer: t_{i+1} = perm[t_i] with prob .7
        self.perm = rng.permutation(v)
        ranks = np.arange(1, v + 1)
        self.marginal = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + c.host_index) * 1_000_033 + step)
        b, s = c.host_batch, c.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.choice(c.vocab_size, b, p=self.marginal)
        follow = rng.random((b, s)) < 0.7
        fresh = rng.choice(c.vocab_size, (b, s), p=self.marginal)
        for t in range(1, s):
            toks[:, t] = np.where(follow[:, t], self.perm[toks[:, t - 1]],
                                  fresh[:, t])
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
