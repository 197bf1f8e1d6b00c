"""Metrics primitives for the serving stack.

One implementation backs every report percentile: a log-bucketed
``Histogram`` with a documented multiplicative error bound, plus the
usual monotone ``Counter`` and last-write ``Gauge``, collected in a
``MetricsRegistry``.

Design notes
------------
The histogram stores sparse integer counts per geometric bucket.  With
growth factor ``g`` the bucket covering value ``v`` spans
``[lo * g**(i-1), lo * g**i)``; ``quantile`` returns the *geometric
midpoint* of the selected bucket, clipped to the observed ``[min, max]``
range.  The returned value is therefore within a relative factor of
``sqrt(g)`` of some observed order statistic at the requested rank —
the documented relative error bound is ``sqrt(g) - 1`` (about 0.1% at
the default ``growth=1.002``).

Quantiles of an *empty* histogram return ``float("nan")`` — the
``NaN``-safe, schema-stable convention the zero-admitted report path
relies on (no silently fabricated ``0.0`` latencies).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_GROWTH",
    "DEFAULT_LO",
]

# Default geometric growth per bucket.  error bound = sqrt(g) - 1 ~= 0.1%,
# fine enough that bucketed p50/p99 agree with np.percentile on every
# workload the benchmarks run (and too fine to collapse A/B deltas).
DEFAULT_GROWTH = 1.002
# Values at or below ``lo`` share bucket 0 (reported as the observed min).
DEFAULT_LO = 1e-3


@dataclass
class Counter:
    """Monotone event counter."""

    name: str
    value: float = 0.0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        self.value += n

    def snapshot(self) -> Dict[str, float]:
        return {"value": float(self.value)}


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    value: float = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, float]:
        return {"value": float(self.value)}


class Histogram:
    """Sparse log-bucketed histogram with bounded-error quantiles.

    Non-negative samples only (it is a log histogram); the serving stack
    feeds it latencies and durations in microseconds.
    """

    def __init__(self, name: str = "", growth: float = DEFAULT_GROWTH,
                 lo: float = DEFAULT_LO) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if lo <= 0.0:
            raise ValueError(f"lo must be > 0, got {lo}")
        self.name = name
        self.growth = float(growth)
        self.lo = float(lo)
        self._log_g = math.log(self.growth)
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording ---------------------------------------------------------

    @property
    def error_bound(self) -> float:
        """Documented relative quantile error: ``sqrt(growth) - 1``."""
        return math.sqrt(self.growth) - 1.0

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        return 1 + int(math.floor(math.log(v / self.lo) / self._log_g))

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            raise ValueError(f"histogram {self.name!r} got NaN sample")
        if v < 0.0:
            raise ValueError(
                f"histogram {self.name!r} is log-bucketed; got {v} < 0")
        b = self._bucket(v)
        self._counts[b] = self._counts.get(b, 0) + 1
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def observe_many(self, values: Union[np.ndarray, Iterable[float]]) -> None:
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray)
                         else values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        if np.isnan(arr).any():
            raise ValueError(f"histogram {self.name!r} got NaN sample")
        if (arr < 0.0).any():
            raise ValueError(
                f"histogram {self.name!r} is log-bucketed; got negatives")
        idx = np.where(
            arr <= self.lo, 0,
            1 + np.floor(np.log(np.maximum(arr, self.lo) / self.lo)
                         / self._log_g).astype(np.int64))
        buckets, counts = np.unique(idx, return_counts=True)
        for b, c in zip(buckets.tolist(), counts.tolist()):
            self._counts[int(b)] = self._counts.get(int(b), 0) + int(c)
        self.count += int(arr.size)
        self.total += float(arr.sum())
        self._min = min(self._min, float(arr.min()))
        self._max = max(self._max, float(arr.max()))

    @classmethod
    def from_values(cls, values: Union[np.ndarray, Iterable[float]],
                    name: str = "", growth: float = DEFAULT_GROWTH,
                    lo: float = DEFAULT_LO) -> "Histogram":
        h = cls(name=name, growth=growth, lo=lo)
        h.observe_many(values)
        return h

    def merge(self, other: "Histogram") -> None:
        if (other.growth, other.lo) != (self.growth, self.lo):
            raise ValueError("cannot merge histograms with different buckets")
        for b, c in other._counts.items():
            self._counts[b] = self._counts.get(b, 0) + c
        self.count += other.count
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)

    # -- reading -----------------------------------------------------------

    @property
    def mean(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.total / self.count

    @property
    def min(self) -> float:
        return self._min if self.count else float("nan")

    @property
    def max(self) -> float:
        return self._max if self.count else float("nan")

    def quantile(self, q: float, default: float = float("nan")) -> float:
        """Value at quantile ``q`` in [0, 1]; ``default`` when empty.

        The result is the geometric midpoint of the bucket holding the
        order statistic at rank ``q * (count - 1)``, clipped to the
        observed range — within ``error_bound`` (relative) of an actual
        sample at that rank.  The empty case is explicit (``default``,
        NaN unless overridden) where ``np.percentile`` would raise: the
        zero-admitted report path leans on this.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return default
        rank = q * (self.count - 1)
        cum = 0
        chosen = None
        for b in sorted(self._counts):
            cum += self._counts[b]
            if cum - 1 >= rank:
                chosen = b
                break
        if chosen is None:        # numerically unreachable; defend anyway
            chosen = max(self._counts)
        if chosen == 0:
            v = self._min
        else:
            edge_lo = self.lo * self.growth ** (chosen - 1)
            v = edge_lo * math.sqrt(self.growth)
        return float(min(max(v, self._min), self._max))

    def percentile(self, p: float, default: float = float("nan")) -> float:
        """np.percentile-style entry point (``p`` in [0, 100])."""
        return self.quantile(p / 100.0, default=default)

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "total": float(self.total),
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "max": self.max,
        }


@dataclass
class MetricsRegistry:
    """Name-keyed get-or-create store for Counters, Gauges, Histograms."""

    _metrics: Dict[str, Union[Counter, Gauge, Histogram]] = field(
        default_factory=dict)

    def _get(self, name: str, kind: type,
             factory) -> Union[Counter, Gauge, Histogram]:
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        m = self._get(name, Counter, lambda: Counter(name))
        assert isinstance(m, Counter)
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._get(name, Gauge, lambda: Gauge(name))
        assert isinstance(m, Gauge)
        return m

    def histogram(self, name: str, growth: float = DEFAULT_GROWTH,
                  lo: float = DEFAULT_LO) -> Histogram:
        m = self._get(name, Histogram,
                      lambda: Histogram(name, growth=growth, lo=lo))
        assert isinstance(m, Histogram)
        return m

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: self._metrics[name].snapshot()
                for name in self.names()}
