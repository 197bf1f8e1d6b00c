"""Each metric reader, and the reading of a profiler trace, on hand-made
input."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench import harness, trace
from bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def record(**kw):
    rec = {"setup_s": 12.5, "window_s": 4.0, "attempted": 800,
           "answered": 800, "latencies_s": np.arange(1, 101) / 1000.0,
           "call_s": np.array([0.01, 0.03]),
           "counts": {"hops": 1600.0, "page_reads": 4000.0,
                      "cache_hits": 1000.0, "mem_hops": 800.0},
           "memgraph": True, "cache": True,
           "profile": {"call_s": 2.0, "call_busy_s": 0.5, "busy_s": 0.6,
                       "window_s": 2.5, "calls": 4, "breakdown": {}}}
    rec.update(kw)
    return rec


EXPECT = {
    "setup_s": 12.5, "search_qps": 200.0, "latency_p95_ms": 95.0,
    "hops_per_query.batch": 2.0, "hops_per_query.online": 2.0,
    "mem_hops_per_query.batch": 1.0, "page_reads_per_query.batch": 5.0,
    "page_reads_per_query.online": 5.0, "cache_hit_share.online": 20.0, "search_call_ms.online": 20.0,
    "device_idle_share.batch": 75.0, "device_idle_share.online": 75.0,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader(name):
    assert harness.reader(ROOT, name)(record()) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name, rec", [
    ("mem_hops_per_query.batch", record(memgraph=False)),
    ("cache_hit_share.online", record(cache=False)),
    ("device_idle_share.batch", record(profile=None)),
    ("latency_p95_ms", record(latencies_s=None)),
])
def test_reader_with_nothing_to_read(name, rec):
    assert harness.reader(ROOT, name)(rec) is None


def test_every_reader_file_is_used():
    stems = {p.stem for p in (ROOT / "bench" / "metrics").glob("*.py")
             if not p.stem.startswith("_")}
    used = {n if n in stems else n.rsplit(".", 1)[0] for n in NAMES}
    assert used == stems


def test_split_metric_falls_back_to_its_base_reader(tmp_path):
    hops = harness.reader(ROOT, "hops_per_query.online")
    assert harness.reader(ROOT, "hops_per_query.bulk")(record()) == hops(
        record())
    (tmp_path / "bench" / "metrics").mkdir(parents=True)
    (tmp_path / "bench" / "metrics" / "x.py").write_text(
        "def read(rec):\n    return 1.0\n")
    (tmp_path / "bench" / "metrics" / "x.own.py").write_text(
        "def read(rec):\n    return 2.0\n")
    assert harness.reader(tmp_path, "x.other")({}) == 1.0
    assert harness.reader(tmp_path, "x.own")({}) == 2.0
    with pytest.raises(FileNotFoundError):
        harness.reader(tmp_path, "y.other")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary():
    events = [
        _ev("user_annotation", trace.CALL, 0, 100),
        _ev("user_annotation", trace.WAIT, 100, 50),
        _ev("user_annotation", trace.CALL, 150, 100),
        _ev("cpu_op", "aten::where", 20, 40),
        _ev("cpu_op", "aten::item", 200, 30),
        _ev("kernel", "k_a", 0, 20),
        _ev("kernel", "k_a", 10, 10),       # overlaps the first
        _ev("gpu_memcpy", "copy", 60, 40),
        _ev("kernel", "k_b", 150, 50),
        _ev("kernel", "k_b", 240, 30),      # runs past the window's end
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(250e-6)
    assert s["busy_s"] == pytest.approx((20 + 40 + 50 + 10) * 1e-6)
    assert s["call_s"] == pytest.approx(200e-6)
    assert s["call_busy_s"] == pytest.approx((20 + 40 + 50 + 10) * 1e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops == pytest.approx({"k_b": 80e-6, "k_a": 30e-6, "copy": 40e-6})
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 20-60 under aten::where, 100-150 the wait, 200-240 under aten::item
    assert gaps == pytest.approx({"aten::where": 40e-6,
                                  trace.WAIT + " (python)": 50e-6,
                                  "aten::item": 40e-6})


def test_trace_without_device_time_reads_nothing():
    assert trace.summarize([_ev("user_annotation", trace.CALL, 0, 10)]) is None
