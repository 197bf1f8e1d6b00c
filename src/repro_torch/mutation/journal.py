"""Durability layer, part 1: the write-ahead mutation journal.

The MutableIndex (repro_torch/mutation/mutable_index.py) is an in-memory model
of an on-disk structure — before this module, process death lost the
delta, the tombstone set, and every in-flight compaction. The journal is
the classic fix, in logical-WAL form: every mutation is appended as a
framed record BEFORE it is applied, and `recover()` (mutable_index.py)
replays the committed prefix through the very same deterministic code
paths, reproducing the pre-crash state bit for bit.

Record framing (the simulated durable medium is a bytearray):

    [u32 body length][u32 crc32(body)][body = pickle((seq, kind, payload))]

A record is DURABLE only once its frame is in `self._log`; appends first
land in a group-commit buffer and reach the log on `sync` — either forced
(`sync=True`: flush/compact intent records, snapshot marks, rng state) or
when `JournalConfig.group_commit` records have accumulated. One sync is
one sequential device write of ceil(bytes / page_bytes) journal pages:
larger group commits amortize the per-sync page rounding, which is the
whole write-amplification story `benchmarks/updates.py` sweeps.

Torn tails: a crash can interrupt a sync half way (`CrashPoint` injects
exactly that: the buffered frames are half-written to the log before the
kill), truncate the last frame, or flip its bytes. `replay()` therefore
walks frames front to back and STOPS at the first length underrun or
crc32 mismatch — the torn tail is discarded, the committed prefix is
trusted. `tear_tail()`/`corrupt_tail()` produce those states on demand
for tests.

`CrashPoint` is the fault-injection hook shared with the data-page write
path (MutableIndex/MutablePageStore call `tick()` once per page write;
the journal ticks once per sync): construct with `kill_at=None` to count
a run's I/O boundaries, then sweep `kill_at` over 1..boundaries to kill
the run at every single one — the crash-point sweep in
tests/test_durability.py.

I/O pricing: the journal never sees the device model. It accumulates
`pending_pages`; `take_pending_io()` hands them (and clears) to whoever
owns the clock — `serve_open_loop` bills them at `write_service_us` on
the background-clock path, and the attached stores book them on the
write-conservation spine (`note_write(kind="journal")`).
"""
from __future__ import annotations

import dataclasses
import pickle
import struct
import zlib
from typing import Any, List, Optional, Tuple

#: record kinds. recover() replays the logical ops (insert/delete/flush/
#: compact); "intent" is the two-phase page-write marker MutablePageStore
#: syncs before touching data pages (replay skips it — logical replay
#: rebuilds every page); "rng" restores the serving loop's generator
#: cursor; "snapshot" marks a checkpoint boundary.
RECORD_KINDS = ("insert", "delete", "flush", "compact", "intent",
                "snapshot", "rng")

_HEADER = struct.Struct("<II")   # (body length, crc32)


@dataclasses.dataclass(frozen=True)
class JournalConfig:
    """Knobs of the write-ahead journal."""

    group_commit: int = 1        # records buffered per sync (1 = every
    #                              record is its own sequential write)
    page_bytes: int = 4096       # journal device page: one sync costs
    #                              ceil(buffered bytes / page_bytes) writes

    def __post_init__(self):
        if self.group_commit < 1:
            raise ValueError(
                f"group_commit={self.group_commit} must be >= 1")
        if self.page_bytes < 1:
            raise ValueError(
                f"page_bytes={self.page_bytes} must be >= 1")


class CrashError(RuntimeError):
    """The injected process death: raised by CrashPoint.tick() at the
    configured I/O boundary. Carries the boundary number so a sweep
    harness can label the kill."""

    def __init__(self, boundary: int):
        super().__init__(f"injected crash at I/O boundary {boundary}")
        self.boundary = boundary


class CrashPoint:
    """Numbered-I/O-boundary fault injection. Every journal sync and every
    data-page write is one boundary (`tick()`); with `kill_at=None` the
    object only counts (`boundaries` after a run is the sweep range), with
    `kill_at=k` the k-th boundary raises CrashError."""

    def __init__(self, kill_at: Optional[int] = None):
        if kill_at is not None and kill_at < 1:
            raise ValueError(f"kill_at={kill_at} must be >= 1 (boundaries "
                             f"are numbered from 1)")
        self.kill_at = kill_at
        self.boundaries = 0
        self.fired = False

    def fires_next(self) -> bool:
        return self.kill_at is not None \
            and self.boundaries + 1 == self.kill_at

    def tick(self) -> None:
        self.boundaries += 1
        if self.kill_at is not None and self.boundaries == self.kill_at:
            self.fired = True
            raise CrashError(self.boundaries)


class MutationJournal:
    """Append-only mutation log over a simulated durable medium.

    The uncommitted group-commit buffer models the volatile write path: a
    crash loses it (and may tear the in-flight sync's bytes into the log —
    see `sync`), while everything in `self._log` survives and `replay()`
    returns it. Sequence numbers are assigned at append time and strictly
    increase; replay validates monotonicity so a corrupted middle record
    cannot silently reorder recovery.
    """

    def __init__(self, cfg: Optional[JournalConfig] = None,
                 crash: Optional[CrashPoint] = None):
        self.cfg = cfg or JournalConfig()
        self.crash = crash
        self._log = bytearray()      # the durable medium
        self._buf: List[bytes] = []  # frames awaiting group commit
        self.seq = 0                 # last sequence number handed out
        self.commits = 0             # syncs that reached the log
        self.records_appended = 0
        self.pages_written = 0       # lifetime journal page writes
        self.pending_pages = 0       # unbilled pages (take_pending_io)
        self.torn_records = 0        # set by replay(): tail dropped as torn

    # -- append / commit ----------------------------------------------------

    @staticmethod
    def _frame(seq: int, kind: str, payload: Any) -> bytes:
        body = pickle.dumps((seq, kind, payload), protocol=4)
        return _HEADER.pack(len(body), zlib.crc32(body)) + body

    def append(self, kind: str, payload: Any = None, *,
               sync: bool = False) -> int:
        """Append one record; returns the journal pages committed by THIS
        call (0 while the record merely joined the group-commit buffer).
        `sync=True` forces the commit — flush/compact intent records must
        be durable before any data page moves (the two-phase rule)."""
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown record kind {kind!r}; one of "
                             f"{RECORD_KINDS}")
        self.seq += 1
        self.records_appended += 1
        self._buf.append(self._frame(self.seq, kind, payload))
        if sync or len(self._buf) >= self.cfg.group_commit:
            return self.sync()
        return 0

    def sync(self) -> int:
        """Commit the buffer as ONE sequential write of
        ceil(bytes / page_bytes) journal pages. This is an I/O boundary:
        with a CrashPoint armed for it, HALF the buffered bytes reach the
        log before the kill — the torn tail replay() must discard."""
        if not self._buf:
            return 0
        blob = b"".join(self._buf)
        if self.crash is not None:
            if self.crash.fires_next():
                self._log += blob[:len(blob) // 2]   # torn write
            self.crash.tick()
        self._log += blob
        self._buf.clear()
        pages = -(-len(blob) // self.cfg.page_bytes)
        self.commits += 1
        self.pages_written += pages
        self.pending_pages += pages
        return pages

    def take_pending_io(self) -> int:
        """Journal pages committed since the last take — the serving loop
        drains this onto the background device clock (write units)."""
        pages, self.pending_pages = self.pending_pages, 0
        return pages

    # -- durable-state inspection -------------------------------------------

    @property
    def log_bytes(self) -> int:
        return len(self._log)

    @property
    def log_pages(self) -> int:
        """Pages a recovery must READ to replay the log."""
        return -(-len(self._log) // self.cfg.page_bytes)

    def replay(self) -> List[Tuple[int, str, Any]]:
        """Decode the DURABLE log into (seq, kind, payload) records,
        discarding the torn tail: the walk stops at the first truncated
        frame, crc32 mismatch, undecodable body, or non-monotone sequence
        number. `self.torn_records` reports whether a tail was dropped."""
        out: List[Tuple[int, str, Any]] = []
        view = bytes(self._log)
        off = 0
        self.torn_records = 0
        last_seq = 0
        while off + _HEADER.size <= len(view):
            length, crc = _HEADER.unpack_from(view, off)
            body = view[off + _HEADER.size: off + _HEADER.size + length]
            if len(body) < length or zlib.crc32(body) != crc:
                self.torn_records = 1
                break
            try:
                seq, kind, payload = pickle.loads(body)
            except Exception:
                self.torn_records = 1
                break
            if seq <= last_seq or kind not in RECORD_KINDS:
                self.torn_records = 1
                break
            out.append((seq, kind, payload))
            last_seq = seq
            off += _HEADER.size + length
        if off != len(view):
            self.torn_records = 1
        return out

    # -- crash surface for tests --------------------------------------------

    def drop_uncommitted(self) -> int:
        """Model the crash's loss of the volatile buffer; returns how many
        records evaporated. (recover() only ever reads the log, so this is
        bookkeeping hygiene for harnesses that reuse the object.)"""
        n = len(self._buf)
        self._buf.clear()
        return n

    def tear_tail(self, nbytes: int = 1) -> None:
        """Truncate the durable log mid-frame (a torn append)."""
        if nbytes < 1:
            raise ValueError(f"nbytes={nbytes} must be >= 1")
        del self._log[max(0, len(self._log) - nbytes):]

    def corrupt_tail(self) -> None:
        """Flip a byte in the last frame's body (bit rot the crc catches)."""
        if not self._log:
            raise ValueError("cannot corrupt an empty journal")
        self._log[-1] ^= 0xFF

    # -- snapshot interplay --------------------------------------------------

    def truncate(self) -> int:
        """A consistent snapshot supersedes the log: drop it (and any
        uncommitted buffer — the snapshot captured that state directly).
        Returns the bytes released. Sequence numbers keep increasing so
        post-snapshot records never collide with pre-snapshot ones."""
        released = len(self._log)
        self._log = bytearray()
        self._buf.clear()
        return released
