"""Span-based tracer with two clocks.

``Tracer()`` (clock "virtual") records *virtual-time microseconds* from the
serving clocks (arrival process, device windows, background clocks) —
never host wall clock — for the serving loops.

``Tracer(clock="host")`` stamps spans on the host's clock for the search
path (``DiskIndex.search``): Unix-epoch microseconds, taken as
``time.perf_counter_ns()`` plus one offset to ``time.time_ns()`` read when
the tracer is made, so stamps never go backwards within a run and sit on
the clock torch.profiler's Chrome trace uses (an event's ``ts`` plus the
trace's ``baseTimeNanoseconds``). Host spans open with ``begin`` and close
with ``end``; a span opened while another is open records that one as its
``parent``, and shares its ``qid`` (the id of the outermost call).

The tracer is a plain append-only list of ``Span`` records; exporting to
Chrome trace-event JSON is a separate, offline step
(``repro_torch.obs.export``).

Zero-cost disabled path: serving and search code hold ``tracer=None`` (or
a ``Tracer(enabled=False)``) and guard every emission with a single
truthiness check — no span objects, no list appends, no arithmetic, no
clock reads.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "TraceSummary", "PHASE_CATS", "CLOCKS"]

# Per-query latency phases; their durations obey the conservation
# contract  queue_us + interference_us + service_us == latency_us.
PHASE_CATS = ("queue", "interference", "service")

# Tracer clock -> the trace's otherData.clock
CLOCKS = {"virtual": "virtual_us", "host": "unix_us"}


@dataclass
class Span:
    """One timed (or instantaneous) event on a (pid, track) lane.

    ``pid`` is the replica group (0 for a single server / control
    plane); ``track`` names the lane within the group ("executor",
    "shard<N>", "background", "migration", "admission", "query").
    ``qid`` ties per-query spans and flow events together (on the host
    clock: the call's id). ``parent`` is the index in ``Tracer.spans`` of
    the host span open when this one began.
    """

    name: str
    cat: str
    t0_us: float
    dur_us: float = 0.0
    pid: int = 0
    track: str = "executor"
    qid: Optional[int] = None
    args: Optional[Dict[str, Any]] = None
    ph: str = "X"
    parent: Optional[int] = None


@dataclass
class TraceSummary:
    """Compact in-memory rollup of a trace."""

    spans: int
    queries: int
    batches: int
    by_cat: Dict[str, float]      # cat   -> total duration (us)
    by_track: Dict[str, float]    # "pid/track" -> busy duration (us)
    max_residual_us: float        # worst per-query conservation residual


class Tracer:
    """Append-only span collector threaded through the serving loops
    (clock "virtual") or the search path (clock "host")."""

    def __init__(self, enabled: bool = True, clock: str = "virtual") -> None:
        if clock not in CLOCKS:
            raise ValueError(
                f"clock={clock!r} must be one of {sorted(CLOCKS)}")
        self.enabled = bool(enabled)
        self.clock = clock
        self.spans: List[Span] = []
        self._open: List[int] = []
        self._calls = 0
        if clock == "host":
            # one offset from the monotonic counter to the Unix epoch, read
            # between two counter reads
            c0 = time.perf_counter_ns()
            wall_ns = time.time_ns()
            c1 = time.perf_counter_ns()
            self._epoch_ns = wall_ns - (c0 + c1) // 2

    def __bool__(self) -> bool:
        return self.enabled

    def __len__(self) -> int:
        return len(self.spans)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str, t0_us: float, dur_us: float, *,
             pid: int = 0, track: str = "executor",
             qid: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name=name, cat=cat, t0_us=float(t0_us),
                               dur_us=float(dur_us), pid=pid, track=track,
                               qid=qid, args=args))

    def instant(self, name: str, cat: str, t_us: float, *,
                pid: int = 0, track: str = "admission",
                qid: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name=name, cat=cat, t0_us=float(t_us),
                               dur_us=0.0, pid=pid, track=track, qid=qid,
                               args=args, ph="i"))

    # -- host clock --------------------------------------------------------

    def _now_us(self) -> float:
        """The host clock: Unix-epoch microseconds."""
        if self.clock != "host":
            raise ValueError("a virtual tracer has no host clock: make it "
                             "with Tracer(clock='host')")
        return (time.perf_counter_ns() + self._epoch_ns) / 1e3

    def begin(self, name: str, cat: str) -> int:
        """Opens a host span now, on the ``search`` lane; returns its index
        for ``end``. Its parent is the innermost span still open; an
        outermost span is a new call and takes the next call id as its
        ``qid``."""
        t0_us = self._now_us()
        parent = self._open[-1] if self._open else None
        if parent is None:
            qid = self._calls
            self._calls += 1
        else:
            qid = self.spans[parent].qid
        self.spans.append(Span(name=name, cat=cat, t0_us=t0_us,
                               track="search", qid=qid, parent=parent))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def end(self, i: int, args: Optional[Dict[str, Any]] = None) -> None:
        """Closes host span ``i`` now, with ``args`` as its args. Spans
        close innermost first."""
        t1_us = self._now_us()
        if not self._open or self._open[-1] != i:
            raise ValueError(f"span {i} is not the innermost open span")
        self._open.pop()
        s = self.spans[i]
        s.dur_us = t1_us - s.t0_us
        s.args = args

    # -- reading -----------------------------------------------------------

    def summary(self) -> TraceSummary:
        by_cat: Dict[str, float] = {}
        by_track: Dict[str, float] = {}
        qids = set()
        batches = 0
        worst_us = 0.0
        for s in self.spans:
            if s.ph == "i":
                continue
            by_cat[s.cat] = by_cat.get(s.cat, 0.0) + s.dur_us
            lane = f"{s.pid}/{s.track}"
            by_track[lane] = by_track.get(lane, 0.0) + s.dur_us
            if s.cat == "batch":
                batches += 1
            elif s.cat == "service":
                if s.qid is not None:
                    qids.add(s.qid)
                if s.args and "latency_us" in s.args:
                    parts_us = (s.args.get("queue_us", 0.0)
                                + s.args.get("interference_us", 0.0)
                                + s.args.get("service_us", 0.0))
                    resid_us = abs(parts_us - s.args["latency_us"])
                    if resid_us > worst_us:
                        worst_us = resid_us
        return TraceSummary(spans=len(self.spans), queries=len(qids),
                            batches=batches, by_cat=by_cat,
                            by_track=by_track, max_residual_us=worst_us)

    def to_chrome(self) -> Dict[str, Any]:
        from repro_torch.obs.export import to_chrome_trace
        return to_chrome_trace(self.spans, clock=CLOCKS[self.clock])

    def export(self, path: str) -> Dict[str, Any]:
        import json
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc
