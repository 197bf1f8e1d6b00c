"""Runtime sanitizer for the port's accounting: a copy of
src/repro/sanitize.py (the port imports nothing of `repro`).

``REPRO_SANITIZE=1`` arms cheap invariant checks at the boundaries every
measurement flows through:

- `StoreCounters` fields are non-negative and monotone (outside `reset()`),
  and every write booking leaves ``pages_written == data_writes +
  journal_writes + snapshot_writes``;
- the serving loops' background clock only moves forward and only by
  non-negative priced durations;
- every open-loop report satisfies ``offered == admitted + shed`` and
  ``completed == admitted``, and its per-query latency attribution sums
  (``queue + service + interference == latency``).

Disabled (the default) each hook is a single falsy-global test; tests and
`chip_smoke.py` flip the switch with `set_enabled`. A violation raises
`SanitizeError`, an `AssertionError` subclass.
"""
from __future__ import annotations

import os

__all__ = ["SanitizeError", "enabled", "set_enabled", "check",
           "check_counters", "check_open_report", "check_attribution"]


class SanitizeError(AssertionError):
    """An accounting invariant the measurements depend on was violated."""


_ENABLED = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the sanitizer (returns the previous state) — test hook, so a
    single process can exercise both armed and disarmed paths."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def check(cond: bool, msg: str) -> None:
    """Assert `cond` when the sanitizer is armed."""
    if _ENABLED and not cond:
        raise SanitizeError(msg)


def check_counters(counters) -> None:
    """Full-state check of one `StoreCounters`: non-negative fields and
    write conservation. Called at every `book_writes` boundary."""
    if not _ENABLED:
        return
    d = counters.as_dict()
    for name, value in d.items():
        if value < 0:
            raise SanitizeError(f"counter {name} is negative: {value}")
    total = d["data_writes"] + d["journal_writes"] + d["snapshot_writes"]
    if d["pages_written"] != total:
        raise SanitizeError(
            f"write conservation broken: pages_written="
            f"{d['pages_written']} != data+journal+snapshot={total} "
            f"({d['data_writes']}+{d['journal_writes']}"
            f"+{d['snapshot_writes']})")


def check_open_report(report) -> None:
    """Admission conservation on a finished serving report: every offered
    query was either admitted or shed, and everything admitted completed."""
    if not _ENABLED:
        return
    offered = int(report.offered)
    admitted = int(report.admitted)
    shed = int(report.shed)
    completed = int(report.completed)
    if offered != admitted + shed:
        raise SanitizeError(
            f"admission conservation broken: offered={offered} != "
            f"admitted={admitted} + shed={shed}")
    if completed != admitted:
        raise SanitizeError(
            f"admitted queries vanished: completed={completed} != "
            f"admitted={admitted}")


def check_attribution(queue_us, service_us, interference_us,
                      latency_us, tol_us: float = 1e-3) -> None:
    """Latency conservation on per-query phase arrays: each phase is
    non-negative and ``queue + service + interference == latency`` within
    ``tol_us`` — every microsecond of a reported latency is attributed,
    none is invented. Called before any open-loop/fleet report returns."""
    if not _ENABLED:
        return
    import numpy as np
    q = np.asarray(queue_us, dtype=np.float64)
    s = np.asarray(service_us, dtype=np.float64)
    i = np.asarray(interference_us, dtype=np.float64)
    lat = np.asarray(latency_us, dtype=np.float64)
    if not (q.shape == s.shape == i.shape == lat.shape):
        raise SanitizeError(
            f"attribution arrays disagree on shape: queue={q.shape} "
            f"service={s.shape} interference={i.shape} latency={lat.shape}")
    for name, arr in (("queue", q), ("service", s), ("interference", i)):
        if arr.size and float(arr.min()) < -tol_us:
            raise SanitizeError(
                f"negative {name} time: min={float(arr.min())}us")
    if q.size:
        resid = np.abs(q + s + i - lat)
        worst = int(np.argmax(resid))
        if float(resid[worst]) > tol_us:
            raise SanitizeError(
                f"latency attribution broken at query {worst}: "
                f"queue={q[worst]} + service={s[worst]} + "
                f"interference={i[worst]} != latency={lat[worst]} "
                f"(residual {float(resid[worst])}us)")
