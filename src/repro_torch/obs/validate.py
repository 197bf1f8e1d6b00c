"""Structural + semantic validation of exported Chrome trace JSON.

Checks the three properties the CI bench-smoke job gates on:

1. events are well-formed (known phase, numeric non-negative ``ts``,
   ``dur`` on complete events, ids on async/flow events);
2. flows resolve (every flow id has a start, steps/finish never move
   backwards in time, and every finish has a start);
3. conservation holds (each ``service`` phase's args satisfy
   ``queue_us + interference_us + service_us == latency_us`` within
   ``CONSERVATION_TOL_US``).

Usable as a library (``validate_chrome_trace(doc) -> [problems]``) or a
CLI: ``python -m repro_torch.obs.validate trace.json``.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

__all__ = ["validate_chrome_trace", "CONSERVATION_TOL_US"]

# "within rounding": the loop computes the split exactly in float64, so a
# nanosecond of absolute slack is generous.
CONSERVATION_TOL_US = 1e-3

_KNOWN_PHASES = {"X", "i", "b", "e", "n", "s", "t", "f", "M"}
_ATTRIB_KEYS = ("latency_us", "queue_us", "interference_us", "service_us")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_chrome_trace(doc: Any) -> List[str]:
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document is not an object with a 'traceEvents' list"]

    async_open: Dict[tuple, int] = {}
    flows: Dict[str, Dict[str, Any]] = {}
    n_service = 0
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        if not _is_num(ev.get("ts")) or ev["ts"] < 0:
            problems.append(f"{where}: ph={ph} missing numeric ts >= 0")
            continue
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"{where}: ph={ph} missing pid/tid")
        if ph == "X":
            if not _is_num(ev.get("dur")) or ev["dur"] < 0:
                problems.append(f"{where}: X event missing dur >= 0")
        elif ph in ("b", "e", "n"):
            if "id" not in ev:
                problems.append(f"{where}: async {ph} event missing id")
                continue
            key = (ev.get("cat"), str(ev["id"]), ev.get("name"))
            if ph == "b":
                async_open[key] = async_open.get(key, 0) + 1
            elif ph == "e":
                if async_open.get(key, 0) <= 0:
                    problems.append(
                        f"{where}: async end with no open begin {key}")
                else:
                    async_open[key] -= 1
            if (ph == "b" and ev.get("cat") == "service"):
                n_service += 1
                args = ev.get("args", {})
                missing = [k for k in _ATTRIB_KEYS
                           if not _is_num(args.get(k))]
                if missing:
                    problems.append(
                        f"{where}: service span missing args {missing}")
                else:
                    resid = abs(args["queue_us"] + args["interference_us"]
                                + args["service_us"] - args["latency_us"])
                    if resid > CONSERVATION_TOL_US:
                        problems.append(
                            f"{where}: conservation violated for qid="
                            f"{args.get('qid')}: residual {resid:.6f}us")
        elif ph in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None:
                problems.append(f"{where}: flow event missing id")
                continue
            st = flows.setdefault(str(fid), {"s": None, "last": None,
                                             "f": False})
            if ph == "s":
                if st["s"] is not None:
                    problems.append(f"{where}: duplicate flow start {fid}")
                st["s"] = ev["ts"]
                st["last"] = ev["ts"]
            else:
                if st["s"] is None:
                    problems.append(
                        f"{where}: flow {ph} before start for id {fid}")
                elif ev["ts"] < st["last"]:
                    problems.append(
                        f"{where}: flow {fid} moves backwards in time")
                else:
                    st["last"] = ev["ts"]
                if ph == "f":
                    st["f"] = True

    for key, n in async_open.items():
        if n != 0:
            problems.append(f"async begin without end: {key} (x{n})")
    for fid, st in flows.items():
        if st["s"] is None or not st["f"]:
            problems.append(f"flow {fid} does not resolve (s..f)")
    if n_service == 0:
        problems.append("trace has no service spans (nothing to attribute)")
    return problems


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate <trace.json>",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems[:40]:
            print(f"TRACE-INVALID: {p}")
        if len(problems) > 40:
            print(f"... and {len(problems) - 40} more")
        return 1
    n = len(doc["traceEvents"])
    print(f"trace OK: {n} events, flows resolve, conservation holds")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
