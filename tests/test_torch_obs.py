"""The port's observability layer (src/repro_torch/obs/) and sanitizer held
against the reference's on the same inputs: histogram quantiles and
snapshots, counter/gauge rows, the Chrome trace export and its validator,
and the sanitizer's open-report and attribution checks."""
import numpy as np
import pytest

import repro.obs as ro
import repro_torch.obs as po
from repro import sanitize as rs
from repro_torch import sanitize as ps


def _lat(seed, n):
    gen = np.random.default_rng(seed)
    return np.exp(gen.normal(5.0, 1.5, size=n)) + 1.0


@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_histogram_quantiles_equal_the_reference(n):
    vals = _lat(n, n)
    a = ro.Histogram.from_values(vals, name="lat")
    b = po.Histogram.from_values(vals, name="lat")
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q, default=-1.0) == b.quantile(q, default=-1.0)
    # str(): an empty histogram's snapshot holds NaNs
    assert str(a.snapshot()) == str(b.snapshot())
    other = _lat(n + 1, 50)
    a.merge(ro.Histogram.from_values(other))
    b.merge(po.Histogram.from_values(other))
    assert str(a.snapshot()) == str(b.snapshot())


def test_registry_rows_equal_the_reference():
    rows = []
    for pkg in (ro, po):
        reg = pkg.MetricsRegistry()
        reg.counter("requests").inc(3)
        reg.counter("requests").inc(2.5)
        reg.gauge("depth").set(7.0)
        reg.gauge("depth").set(4.0)
        reg.histogram("lat").observe_many(_lat(3, 100))
        rows.append((reg.names(), reg.as_dict()))
    assert rows[0] == rows[1]


def _spans(tracer):
    """A small hand-made run: two queries through one batch on two
    shards, with background work and hop markers."""
    tracer.instant("arrival", "admission", 0.0, track="admission", qid=0)
    tracer.instant("arrival", "admission", 5.0, track="admission", qid=1)
    tracer.span("batch", "batch", 20.0, 100.0, track="executor",
                args={"size": 2, "level": 0})
    tracer.span("device", "device", 20.0, 60.0, track="shard1",
                args={"issued": 3})
    tracer.span("flushes", "bg", 10.0, 8.0, track="background",
                args={"pages_read": 1, "pages_written": 2})
    for qid, t_arr in ((0, 0.0), (1, 5.0)):
        q_us = 18.0 - t_arr
        tracer.span("queue", "queue", t_arr, q_us, track="query", qid=qid)
        tracer.span("interference", "interference", 18.0, 2.0,
                    track="query", qid=qid)
        tracer.span("service", "service", 20.0, 100.0, track="query",
                    qid=qid, args={"latency_us": q_us + 102.0,
                                   "queue_us": q_us,
                                   "interference_us": 2.0,
                                   "service_us": 100.0})
        tracer.span("hop0", "hop", 20.0, 30.0, track="query", qid=qid,
                    args={"hop": 0, "pages": 2})


def _drop_source(doc):
    doc = dict(doc)
    doc["otherData"] = {k: v for k, v in doc["otherData"].items()
                        if k != "source"}
    return doc


def test_chrome_trace_equals_the_reference():
    a, b = ro.Tracer(), po.Tracer()
    _spans(a)
    _spans(b)
    da, db = a.to_chrome(), b.to_chrome()
    assert db["otherData"]["source"] == "repro_torch.obs"
    assert _drop_source(da) == _drop_source(db)
    assert po.validate_chrome_trace(db) == ro.validate_chrome_trace(da) == []
    assert vars(a.summary()) == vars(b.summary())


def test_validator_flags_the_same_problems():
    t = ro.Tracer()
    _spans(t)
    doc = t.to_chrome()
    for ev in doc["traceEvents"]:
        if ev.get("name") == "service" and ev.get("ph") == "b":
            ev["args"]["latency_us"] += 5.0
    doc["traceEvents"].append({"ph": "Q", "ts": -1.0})
    assert po.validate_chrome_trace(doc) == ro.validate_chrome_trace(doc)
    assert len(po.validate_chrome_trace(doc)) >= 2


def test_sanitizer_open_report_and_attribution_checks():
    class Report:
        offered, admitted, shed, completed = 10, 7, 3, 7

    q = np.array([1.0, 2.0])
    s = np.array([3.0, 4.0])
    i = np.array([0.0, 0.5])
    for mod in (rs, ps):
        prev = mod.set_enabled(True)
        try:
            mod.check_open_report(Report())
            mod.check_attribution(q, s, i, q + s + i)
            bad = Report()
            bad.shed = 2
            with pytest.raises(mod.SanitizeError, match="offered=10"):
                mod.check_open_report(bad)
            with pytest.raises(mod.SanitizeError, match="query 1"):
                mod.check_attribution(q, s, i, q + s + i + [0.0, 1.0])
            with pytest.raises(mod.SanitizeError, match="negative queue"):
                mod.check_attribution(-q, s, i, s + i - q)
        finally:
            assert mod.set_enabled(prev) is True
        if not prev:
            mod.check_attribution(q, s, i, q)      # disarmed: no check
