"""Streaming index mutations: delta graph, tombstones, page versioning,
background compaction, and the durability layer — write-ahead journal,
crash-point fault injection, snapshots, and `recover()`. The port of
src/repro/mutation/: the host state is numpy as in the reference (journals
and snapshots carry numpy arrays and Python values, so either package
replays the other's), and the device work — the insert wiring search, PQ
encoding, the delta scan — runs on the base index's device."""
from repro_torch.mutation.compactor import (COMPACTION_POLICIES, Compactor,
                                            MutationMix)
from repro_torch.mutation.delta_index import DeltaIndex
from repro_torch.mutation.journal import (RECORD_KINDS, CrashError,
                                          CrashPoint, JournalConfig,
                                          MutationJournal)
from repro_torch.mutation.mutable_index import (MutableIndex, MutationConfig,
                                                recover)
from repro_torch.mutation.mutable_store import MutablePageStore

__all__ = ["COMPACTION_POLICIES", "Compactor", "CrashError", "CrashPoint",
           "DeltaIndex", "JournalConfig", "MutableIndex",
           "MutablePageStore", "MutationConfig", "MutationJournal",
           "MutationMix", "RECORD_KINDS", "recover"]
