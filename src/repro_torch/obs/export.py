"""Chrome trace-event JSON exporter (Perfetto-loadable).

Mapping (see docs/observability.md for the full schema):

- ``pid``  = replica group (0 for a single server / the control plane)
- ``tid``  = lane within the group: admission, executor, background,
  migration, the per-query async lane, and one lane per shard
- batch / device / background / migration spans -> complete ``"X"``
  events with ``ts``/``dur`` in virtual microseconds
- per-query latency phases (queue / interference / service) -> nestable
  async ``"b"``/``"e"`` pairs keyed by the query id, so overlapping
  queries each get their own row in the UI
- per-hop device markers -> nestable async instants (``"n"``) under the
  same query id, with per-shard page counts in ``args``
- one flow per query (``"s"`` at arrival, ``"t"`` at dispatch, ``"f"``
  at completion) visually links admission -> executor batch -> done
- ``"M"`` metadata names every process and thread
- host-clock spans (``Tracer(clock="host")``, the search path) -> complete
  ``"X"`` events on the ``search`` lane with ``ts`` in Unix-epoch
  microseconds, the call id as ``args.qid`` and the parent span's index
  as ``args.parent``; ``otherData.clock`` is ``"unix_us"``.
  ``on_profiler_clock`` moves them onto a torch.profiler trace's timeline

The ``service`` phase's ``args`` carry the attribution tuple
(``latency_us``/``queue_us``/``interference_us``/``service_us``) so a
trace file is self-validating (``repro_torch.obs.validate``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.obs.tracer import PHASE_CATS, Span

__all__ = ["to_chrome_trace", "tid_for_track", "on_profiler_clock"]

_TRACK_TIDS = {
    "admission": 0,
    "executor": 1,
    "query": 2,
    "background": 3,
    "migration": 4,
    "search": 5,
}
_SHARD_TID_BASE = 10
_FALLBACK_TID = 9


def tid_for_track(track: str) -> int:
    if track.startswith("shard"):
        suffix = track[len("shard"):]
        return _SHARD_TID_BASE + (int(suffix) if suffix.isdigit() else 0)
    return _TRACK_TIDS.get(track, _FALLBACK_TID)


def _meta(pid: int, name: str, tid: int = 0, *,
          kind: str = "process_name") -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "tid": tid, "name": kind,
            "args": {"name": name}}


def to_chrome_trace(spans: Sequence[Span],
                    clock: str = "virtual_us") -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    lanes: Dict[Tuple[int, str], int] = {}
    for s in spans:
        lanes.setdefault((s.pid, s.track), tid_for_track(s.track))

    for pid in sorted({p for p, _ in lanes}):
        events.append(_meta(pid, f"replica_group_{pid}" if clock ==
                            "virtual_us" else f"host_{pid}"))
    for (pid, track), tid in sorted(lanes.items()):
        events.append(_meta(pid, track, tid, kind="thread_name"))
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": tid}})

    body: List[Dict[str, Any]] = []
    service: Dict[int, Span] = {}
    queue_t0: Dict[int, float] = {}
    for s in spans:
        tid = lanes[(s.pid, s.track)]
        base = {"name": s.name, "cat": s.cat, "pid": s.pid, "tid": tid,
                "ts": s.t0_us}
        if s.args:
            base["args"] = dict(s.args)
        if s.qid is not None:
            base.setdefault("args", {})["qid"] = s.qid
        if s.parent is not None:
            base.setdefault("args", {})["parent"] = s.parent
        if s.cat in PHASE_CATS:
            qid = str(s.qid)
            body.append({**base, "ph": "b", "id": qid})
            end = dict(base)
            end.pop("args", None)
            body.append({**end, "ph": "e", "id": qid,
                         "ts": s.t0_us + s.dur_us})
            if s.cat == "service" and s.qid is not None:
                service[s.qid] = s
            elif s.cat == "queue" and s.qid is not None:
                queue_t0[s.qid] = s.t0_us
        elif s.cat == "hop":
            body.append({**base, "ph": "n", "id": str(s.qid)})
        elif s.ph == "i":
            body.append({**base, "ph": "i", "s": "t"})
        else:
            body.append({**base, "ph": "X", "dur": s.dur_us})

    # one flow per completed query: arrival -> dispatch -> completion
    exec_lane = dict(lanes)
    for qid, s in sorted(service.items()):
        tid_exec = exec_lane.get((s.pid, "executor"),
                                 tid_for_track("executor"))
        tid_adm = exec_lane.get((s.pid, "admission"),
                                tid_for_track("admission"))
        flow = {"cat": "qflow", "id": str(qid), "name": f"q{qid}",
                "pid": s.pid}
        body.append({**flow, "ph": "s", "tid": tid_adm,
                     "ts": queue_t0.get(qid, s.t0_us)})
        body.append({**flow, "ph": "t", "tid": tid_exec, "ts": s.t0_us})
        body.append({**flow, "ph": "f", "bp": "e", "tid": tid_exec,
                     "ts": s.t0_us + s.dur_us})

    body.sort(key=lambda e: e["ts"])
    return {"traceEvents": events + body, "displayTimeUnit": "ms",
            "otherData": {"clock": clock, "source": "repro_torch.obs"}}


def on_profiler_clock(doc: Dict[str, Any],
                      base_ns: int) -> List[Dict[str, Any]]:
    """The timed events of a host-clock trace (``otherData.clock ==
    "unix_us"``) with ``ts`` moved onto a torch.profiler Chrome trace's
    timeline, whose events stamp ``ts`` in microseconds after the trace's
    ``baseTimeNanoseconds`` (``base_ns``). Append them to that trace's
    ``traceEvents`` to see both in one view."""
    if doc.get("otherData", {}).get("clock") != "unix_us":
        raise ValueError("only a host-clock trace (otherData.clock == "
                         "'unix_us') shares the profiler's clock")
    base_us = int(base_ns) // 1000
    frac_us = (int(base_ns) % 1000) / 1e3
    return [{**ev, "ts": ev["ts"] - base_us - frac_us}
            for ev in doc["traceEvents"] if ev.get("ph") != "M"]
