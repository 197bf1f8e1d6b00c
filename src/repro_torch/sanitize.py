"""Runtime sanitizer for the port's I/O accounting: the part of
src/repro/sanitize.py that the port's page stores call, copied (the port
imports nothing of `repro`).

``REPRO_SANITIZE=1`` arms the checks: `StoreCounters` fields stay
non-negative and monotone outside `reset()`, and every write booking leaves
``pages_written == data_writes + journal_writes + snapshot_writes``.
Disabled (the default) each hook is a single falsy-global test. A violation
raises `SanitizeError`, an `AssertionError` subclass.
"""
from __future__ import annotations

import os

__all__ = ["SanitizeError", "enabled", "check", "check_counters"]


class SanitizeError(AssertionError):
    """An accounting invariant the measurements depend on was violated."""


_ENABLED = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def enabled() -> bool:
    return _ENABLED


def check(cond: bool, msg: str) -> None:
    """Assert `cond` when the sanitizer is armed."""
    if _ENABLED and not cond:
        raise SanitizeError(msg)


def check_counters(counters) -> None:
    """Full-state check of one `StoreCounters`: non-negative fields and
    write conservation."""
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
            f"{d['pages_written']} != data+journal+snapshot={total}")
