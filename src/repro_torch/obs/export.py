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

The ``service`` phase's ``args`` carry the attribution tuple
(``latency_us``/``queue_us``/``interference_us``/``service_us``) so a
trace file is self-validating (``repro_torch.obs.validate``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.obs.tracer import PHASE_CATS, Span

__all__ = ["to_chrome_trace", "tid_for_track"]

_TRACK_TIDS = {
    "admission": 0,
    "executor": 1,
    "query": 2,
    "background": 3,
    "migration": 4,
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


def to_chrome_trace(spans: Sequence[Span]) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    lanes: Dict[Tuple[int, str], int] = {}
    for s in spans:
        lanes.setdefault((s.pid, s.track), tid_for_track(s.track))

    for pid in sorted({p for p, _ in lanes}):
        events.append(_meta(pid, f"replica_group_{pid}"))
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
            "otherData": {"clock": "virtual_us",
                          "source": "repro_torch.obs"}}
