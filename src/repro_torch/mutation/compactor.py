"""Background compaction scheduling + the serving-side mutation workload.

The MutableIndex (repro_torch/mutation/mutable_index.py) exposes the MECHANISM
(`compact(max_pages)`); this module owns the POLICY — when the background
repair runs against a live serving loop:

  none        never compact: the dirty set and the tombstone backlog grow
              without bound, and the append zone's locality decay compounds
              — the degradation baseline `benchmarks/updates.py` measures.
  threshold   compact (one bounded run) whenever the dirty-page fraction
              crosses `threshold` — the batch-repair shape real systems
              ship (FreshDiskANN's periodic consolidation).
  continuous  a bounded run after every dispatched batch — smallest
              backlog, steadiest I/O tax.

Scheduling contract: the compactor never runs concurrently with itself,
every run is bounded by `max_pages`, and ALL of its I/O (page reads +
rewrites) is returned to the caller so the serving loop can charge it
against the device — compaction competes with query I/O for the same
queue, which is the entire point of measuring it.

`MutationMix` is the open-loop workload spec: the fraction of arrivals
that are inserts/deletes (the rest are reads), plus the compaction policy
riding on the same config so one object describes a streaming cell.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: serve_open_loop(mutation_mix=) / benchmarks compaction policy names.
COMPACTION_POLICIES = ("none", "threshold", "continuous")


@dataclasses.dataclass(frozen=True)
class MutationMix:
    """Open-loop arrival mix + compaction policy for one streaming cell."""

    insert_frac: float = 0.0     # fraction of arrivals that are inserts
    delete_frac: float = 0.0     # fraction of arrivals that are deletes
    compaction: str = "none"     # COMPACTION_POLICIES
    threshold: float = 0.25      # dirty-page fraction that triggers a
    #                              "threshold" run
    max_pages: int = 8           # dirty-page budget per compaction run
    seed: int = 0                # DEPRECATED and unread: serve_open_loop
    #                              draws arrival kinds and delete victims
    #                              from the SAME seeded rng as the Poisson
    #                              arrivals (one seed reproduces the whole
    #                              run); kept so existing cell specs parse

    def __post_init__(self):
        if not 0.0 <= self.insert_frac <= 1.0:
            raise ValueError(
                f"insert_frac={self.insert_frac} must be in [0, 1]")
        if not 0.0 <= self.delete_frac <= 1.0:
            raise ValueError(
                f"delete_frac={self.delete_frac} must be in [0, 1]")
        if self.insert_frac + self.delete_frac > 1.0:
            raise ValueError(
                f"insert_frac + delete_frac = "
                f"{self.insert_frac + self.delete_frac} leaves no reads "
                f"(must be <= 1)")
        if self.compaction not in COMPACTION_POLICIES:
            raise ValueError(
                f"compaction={self.compaction!r} must be one of "
                f"{COMPACTION_POLICIES}")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError(
                f"threshold={self.threshold} must be in (0, 1]")
        if self.max_pages < 1:
            raise ValueError(f"max_pages={self.max_pages} must be >= 1")

    @property
    def read_frac(self) -> float:
        return 1.0 - self.insert_frac - self.delete_frac

    @property
    def mutating(self) -> bool:
        return self.insert_frac > 0 or self.delete_frac > 0


class Compactor:
    """Policy driver binding a MutationMix's compaction schedule to a
    MutableIndex. The serving loop calls the two hooks; each returns the
    run's accounting dict (see MutableIndex.compact) or None when the
    policy declined to run."""

    def __init__(self, index, mix: MutationMix):
        self.index = index
        self.mix = mix
        self.runs = 0

    def _run(self) -> Optional[dict]:
        if not self.index.dirty_pages:
            return None
        acct = self.index.compact(self.mix.max_pages)
        self.runs += 1
        return acct

    def after_mutation(self) -> Optional[dict]:
        """Hook after every applied insert/delete/flush: the "threshold"
        policy fires here when the dirty fraction crosses the line."""
        if self.mix.compaction != "threshold":
            return None
        if self.index.dirty_fraction < self.mix.threshold:
            return None
        return self._run()

    def after_batch(self) -> Optional[dict]:
        """Hook after every dispatched query batch: the "continuous"
        policy's steady bounded repair."""
        if self.mix.compaction != "continuous":
            return None
        return self._run()
