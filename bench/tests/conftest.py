"""Tiny cells of the benchmark on the CPU: the real cell entries, with the
configuration cut to a few thousand vectors and a small graph, and the index
cache in a temporary directory."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def shrink(cell, n: int = 1024):
    cell.config["n"] = n
    cell.config["vamana"].update(R=16, L_build=32, batch=1024)
    cell.mix.update(pool=128, sample=24)
    if cell.mix["loop"] == "closed":
        cell.mix["batch"] = 32
    else:
        cell.mix["rate_per_s"] = 30.0
    return cell


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while these tests run: the suite's workers
    share the cores, and the tiny searches gain nothing from more."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cache_base(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_index")


@pytest.fixture
def tiny_cell():
    from bench import harness

    def make(workload: str):
        return shrink(harness.load_cell(ROOT, workload))
    return make


@pytest.fixture
def loaded_before(monkeypatch):
    """A run prints no result where the JAX package is loaded. In a test
    worker shared with other files it may be loaded already; the runs here
    count only what loads while they run."""
    from bench import harness
    before = {m.split(".")[0] for m in sys.modules}
    found = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: [m for m in found() if m not in before])
