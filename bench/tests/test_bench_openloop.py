"""The open loop's arithmetic: arrivals, exact percentiles, latency from
the due time, and the generator's lateness."""
from __future__ import annotations

import time

import numpy as np
import pytest

from bench import traffic


def test_nearest_rank_percentile():
    v = np.arange(1, 101, dtype=float)[::-1]
    assert traffic.nearest_rank(v, 95) == 95.0
    assert traffic.nearest_rank(v, 50) == 50.0
    assert traffic.nearest_rank(v, 100) == 100.0
    assert traffic.nearest_rank([7.0], 95) == 7.0
    assert traffic.nearest_rank(np.arange(1, 21, dtype=float), 95) == 19.0


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 11, -3, 2 ** 70])
def test_arrivals_same_gaps_in_another_order(seed):
    base = traffic.arrivals(50.0, 10.0, 0, 1)
    due = traffic.arrivals(50.0, 10.0, 0, seed)
    assert len(due) == 500 and due[0] == 0.0
    assert np.all(np.diff(due) > 0) and due[-1] < 10.0
    gaps = lambda d: np.sort(np.diff(np.append(d, 10.0)))  # noqa: E731
    np.testing.assert_allclose(gaps(due), gaps(base), rtol=1e-9, atol=1e-12)
    again = traffic.arrivals(50.0, 10.0, 0, seed)
    np.testing.assert_array_equal(due, again)


class _Stats:
    def __init__(self, n):
        self.n = n


def test_open_loop_times_from_due_and_batches_what_arrived():
    service = 0.05
    sizes = []

    def search(qb, cap):
        sizes.append(len(qb))
        assert len(qb) <= cap
        time.sleep(service)
        return _Stats(len(qb))

    mix = {"rate_per_s": 100.0, "max_batch": 4, "gap_seed": 0,
           "drain_s": 5.0}
    q = np.zeros((10, 2), np.float32)
    w = traffic.open_loop(search, q, mix, 0.5, False, lambda: None, 9)
    due = traffic.arrivals(100.0, 0.5, 0, 9)
    assert w.attempted == len(due) == 50 and w.failed == 0
    assert sum(sizes) == 50 and max(sizes) == 4
    # each request waits at least its call's service, counted from due
    assert np.all(w.latencies >= service)
    ends = np.concatenate([[c.end] * len(c.rows) for c in w.calls])
    np.testing.assert_allclose(w.latencies, ends - due, atol=1e-9)


def test_open_loop_lateness_of_an_idle_dispatcher():
    mix = {"rate_per_s": 40.0, "max_batch": 4, "gap_seed": 0,
           "drain_s": 5.0}
    w = traffic.open_loop(lambda qb, cap: _Stats(len(qb)), np.zeros((5, 2)),
                          mix, 0.5, False, lambda: None, 3)
    # it waits for most arrivals (not where one is due before the last
    # call returned), never wakes early, and is late by a sleep's overshoot
    assert w.attempted // 2 <= len(w.lateness) <= w.attempted - 1
    assert np.all(w.lateness >= 0) and w.lateness.max() < 0.05


def test_open_loop_counts_what_never_comes():
    def search(qb, cap):
        time.sleep(0.2)
        return _Stats(len(qb))

    mix = {"rate_per_s": 200.0, "max_batch": 1, "gap_seed": 0,
           "drain_s": 0.0}
    w = traffic.open_loop(search, np.zeros((4, 2)), mix, 0.3, False,
                          lambda: None, 1)
    assert w.attempted == 60 and 0 < w.failed < 60
    assert len(w.latencies) == w.attempted - w.failed


def test_closed_loop_covers_the_window():
    def search(qb, batch):
        time.sleep(0.01)
        return _Stats(len(qb))

    w = traffic.closed_loop(search, np.zeros((10, 2)), {"batch": 4}, 0.1,
                            False, lambda: None)
    assert w.seconds >= 0.1 and w.attempted == 4 * len(w.calls)
    rows = np.concatenate([c.rows for c in w.calls])
    np.testing.assert_array_equal(rows, np.arange(len(rows)) % 10)
