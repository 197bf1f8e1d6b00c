"""The one traffic generator and its two loops.

A traffic mix is a JSON file in `bench/traffic/`; this module reads its
parameters and nothing else:

  loop         "closed": one client sends `batch` queries a call, the next
               call once the last has returned; "open": single queries
               arrive on a schedule at `rate_per_s` and a dispatcher sends
               every query that has arrived, up to `max_batch`, in one call
               whenever the previous call has returned.
  pool         queries drawn from the run seed, sent in pool order and
               again from the start once the pool is used up.
  sample       how many answers the comparison with the reference checks.
  profile_calls / profile_seconds   how much of a traced window the
               profiler records.
  drain_s      (open) how long past the window's close the dispatcher may
               take to answer what arrived in it; what is left then failed.

Open-loop arrivals: `round(rate_per_s * seconds)` gaps drawn once from an
exponential distribution with a fixed generator (`gap_seed`), scaled so
they fill the window, and put in another order by each run seed: every seed
offers the same number of arrivals and the same gaps. Each query is timed
from when it was due, not from when it was sent.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from bench import trace
from bench.data import seed_words


@dataclasses.dataclass
class Call:
    start: float          # seconds from the window's start
    end: float
    rows: np.ndarray      # pool indices of the queries sent
    stats: object         # the program's QueryStats for them


@dataclasses.dataclass
class Window:
    calls: list
    seconds: float        # from the window's start to the last call's end
    attempted: int
    failed: int
    latencies: np.ndarray | None = None   # open loop: due to answered, s
    lateness: np.ndarray | None = None    # open loop: late wake-ups, s
    profile: dict | None = None


def arrivals(rate: float, seconds: float, gap_seed: int, seed: int):
    """Due times (s) of the open loop's arrivals, all inside the window."""
    count = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(gap_seed).exponential(1.0 / rate, count)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([0xA7] + seed_words(seed)).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]


def nearest_rank(values, pct: float) -> float:
    """The exact pct-th percentile by nearest rank over all values."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, math.ceil(pct / 100.0 * len(v)) - 1)])


def warm_sizes(mix: dict) -> list:
    """The call sizes a mix sends: set-up runs each once."""
    if mix["loop"] == "closed":
        return [mix["batch"]]
    return list(range(1, mix["max_batch"] + 1))


def _profile(mix: dict, traced: bool):
    if not traced:
        return None
    return trace.Profile(calls=mix.get("profile_calls"),
                         seconds=mix.get("profile_seconds"))


def closed_loop(search, queries, mix: dict, seconds: float, traced: bool,
                sync) -> Window:
    batch, pool = mix["batch"], len(queries)
    prof = _profile(mix, traced)
    calls, pos = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rows = np.arange(pos, pos + batch) % pool
        pos += batch
        ts = time.perf_counter() - t0
        with trace.span(trace.CALL):
            st = search(queries[rows], batch)
            sync()
        te = time.perf_counter() - t0
        calls.append(Call(ts, te, rows, st))
        if prof is not None:
            prof.step(len(calls), te)
    window = Window(calls, calls[-1].end, len(calls) * batch, 0)
    if prof is not None:
        window.profile = prof.result()
    return window


def open_loop(search, queries, mix: dict, seconds: float, traced: bool,
              sync, seed: int) -> Window:
    due = arrivals(mix["rate_per_s"], seconds, mix["gap_seed"], seed)
    n, pool, cap = len(due), len(queries), mix["max_batch"]
    deadline = seconds + mix["drain_s"]
    prof = _profile(mix, traced)
    calls, late = [], []
    lat = np.full(n, np.nan)
    i = 0
    t0 = time.perf_counter()
    while i < n:
        now = time.perf_counter() - t0
        if now > deadline:
            break
        if due[i] > now:
            with trace.span(trace.WAIT):
                while due[i] - now > 2e-3:
                    time.sleep(due[i] - now - 1e-3)
                    now = time.perf_counter() - t0
                while now < due[i]:
                    now = time.perf_counter() - t0
            late.append(now - due[i])
        j = i + int(np.searchsorted(due[i:i + cap], now, side="right"))
        rows = np.arange(i, j) % pool
        with trace.span(trace.CALL):
            st = search(queries[rows], cap)
            sync()
        te = time.perf_counter() - t0
        calls.append(Call(now, te, rows, st))
        lat[i:j] = te - due[i:j]
        i = j
        if prof is not None:
            prof.step(len(calls), te)
    end = calls[-1].end if calls else time.perf_counter() - t0
    window = Window(calls, end, n, int(np.isnan(lat).sum()), lat[~np.isnan(lat)],
                    np.asarray(late))
    if prof is not None:
        window.profile = prof.result()
    return window


def drive(search, queries, mix: dict, seconds: float, traced: bool, sync,
          seed: int) -> Window:
    if mix["loop"] == "closed":
        return closed_loop(search, queries, mix, seconds, traced, sync)
    if mix["loop"] == "open":
        return open_loop(search, queries, mix, seconds, traced, sync, seed)
    raise ValueError(f"unknown loop {mix['loop']!r}: 'closed' or 'open'")
