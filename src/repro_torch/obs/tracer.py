"""Span-based tracer for the virtual-time serving loops.

Every timestamp recorded here is *virtual-time microseconds* from the
serving clocks (arrival process, device windows, background clocks) —
never host wall clock.  The tracer is a plain append-only list of
``Span`` records; exporting to Chrome trace-event JSON is a separate,
offline step (``repro_torch.obs.export``).

Zero-cost disabled path: serving code holds ``tracer=None`` (or a
``Tracer(enabled=False)``) and guards every emission with a single
truthiness check — no span objects, no list appends, no arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "TraceSummary", "PHASE_CATS"]

# Per-query latency phases; their durations obey the conservation
# contract  queue_us + interference_us + service_us == latency_us.
PHASE_CATS = ("queue", "interference", "service")


@dataclass
class Span:
    """One timed (or instantaneous) event on a (pid, track) lane.

    ``pid`` is the replica group (0 for a single server / control
    plane); ``track`` names the lane within the group ("executor",
    "shard<N>", "background", "migration", "admission", "query").
    ``qid`` ties per-query spans and flow events together.
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
    """Append-only span collector threaded through the serving loops."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.spans: List[Span] = []

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
        return to_chrome_trace(self.spans)

    def export(self, path: str) -> Dict[str, Any]:
        import json
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc
