"""The traced window: torch.profiler over the first calls of a window, read
back as intervals.

The harness marks its own spans with `record_function` (`bench.call`
around each call into the program, `bench.wait` around an open loop's wait
for the next arrival), so they sit in the profiler's trace on the same
clock as the device's operations. From the exported trace this module
takes the union of device operation intervals (kernels, copies, sets): how
long the device was busy in the window and inside the calls, which device
operations took the most time, and what the host was doing in the longest
device idle gaps. torch.profiler is imported with this module, in set-up:
its first import takes seconds.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench.call"
WAIT = "bench.wait"


def short(name: str) -> str:
    """A device operation's name without `void ` and cut to 120 characters
    (PyTorch's kernels differ in template arguments deep in their names);
    operations of one short name are summed."""
    name = name[5:] if name.startswith("void ") else name
    return name[:120]


def union(intervals):
    """Sorted, merged [start, end] pairs of `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(merged, s, e) -> float:
    """Length of [s, e] covered by the merged intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


def summarize(events: list) -> dict | None:
    """Reads chrome-trace events (dicts with ph, cat, name, ts, dur in us).
    Returns seconds: window_s (first to last harness span), busy_s (device
    busy in it), call_s and call_busy_s (inside `bench.call` spans), and
    `breakdown`; None where the trace holds no harness span or no device
    operation."""
    dev, spans, ops = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e, short(ev["name"])))
        elif cat == "user_annotation" and ev["name"] in (CALL, WAIT):
            spans.append((s, e, ev["name"]))
        elif cat == "cpu_op":
            ops.append((s, e, ev["name"]))
    if not spans or not dev:
        return None
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    busy = union([(max(s, w0), min(e, w1)) for s, e, _ in dev
                  if e > w0 and s < w1])
    calls = [(s, e) for s, e, n in spans if n == CALL]
    call_s = sum(e - s for s, e in calls)
    call_busy = sum(covered(busy, s, e) for s, e in calls)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += e - s
    ops.sort()
    starts = [s for s, _, _ in ops]
    gaps = defaultdict(float)
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps[_doing(0.5 * (prev + a), starts, ops, spans)] += a - prev
        prev = max(prev, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    us = 1e-6
    return {"window_s": (w1 - w0) * us,
            "busy_s": sum(b - a for a, b in busy) * us,
            "call_s": call_s * us, "call_busy_s": call_busy * us,
            "calls": len(calls),
            "breakdown": {"device_ops": [[n, v * us] for n, v in top],
                          "idle_gaps": [[n, v * us] for n, v in idle]}}


def _doing(mid, starts, ops, spans) -> str:
    """What the host was doing at `mid`: the innermost profiler operator
    open then (operators of one thread nest, so it is the latest-starting
    one still open), else the harness span."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - 256), -1):
        if ops[j][1] >= mid:
            return ops[j][2]
    for s, e, name in spans:
        if s <= mid <= e:
            return name + " (python)"
    return "between spans"


class Profile:
    """Profiles the first calls of a window. `step(calls, elapsed)` after
    each call stops it once `calls` or `seconds` are reached; `result()`
    exports, parses and deletes the trace."""

    def __init__(self, calls: int | None = None, seconds: float | None = None):
        import torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.calls, self.seconds = calls, seconds
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.on = True

    def step(self, calls: int, elapsed: float) -> None:
        if self.on and ((self.calls is not None and calls >= self.calls) or
                        (self.seconds is not None and elapsed >= self.seconds)):
            self.stop()

    def stop(self) -> None:
        if self.on:
            self.prof.__exit__(None, None, None)
            self.on = False

    def result(self) -> dict | None:
        self.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return summarize(events)


def span(name: str):
    """A harness span in the profiler's trace (a no-op when none runs)."""
    return record_function(name)
