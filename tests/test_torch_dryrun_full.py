"""The port's dry run at full production size on the CPU, its launcher, and
`ParallelContext.constrain` on a mesh of more than one device.

The full-size cells run in a subprocess on a fake process group of fake
CPU tensors (a fake group cannot share a process with the gloo groups of
other tests):

- tinyllama-1.1b train_4k under "fsdp" on (16, 16): pure data parallelism
  computes nothing twice, so its per-device FLOPs times 256 equal the
  FLOPs of the same step on a one-device mesh within 0.1%;
- qwen2-moe-a2.7b decode_32k ("tp", expert-parallel) is ok and records
  the all-reduce of its experts' partial outputs over `model`;
- `main` writes one record per cell under the tag's directory, counts the
  long-context cells n/a, and exits 1 when a cell fails.

`constrain`, and the gradient of `comm.all_gather` (the expert weights'
FSDP gather), run in 2 gloo ranks (`launch.mesh.run_in_processes`).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_in_processes

SRC = str(Path(__file__).resolve().parent.parent / "src")
TIMEOUT = 600
RANK_TIMEOUT = 120

_FULL = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_ranks, make_production_mesh

out = {}
init_fake_ranks(1)
one = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                 mesh_dim_names=("data", "model"))
cell = dryrun.build_cell("tinyllama-1.1b", "train_4k", one, device="cpu")
out["one_device"] = {"profile": cell.ctx.profile,
                     "flops": dryrun.count_step(cell)["flops"]}
dist.destroy_process_group()

init_fake_ranks(256)
mesh = make_production_mesh(device="cpu")
for arch, shape in (("tinyllama-1.1b", "train_4k"),
                    ("qwen2-moe-a2.7b", "decode_32k")):
    cell = dryrun.build_cell(arch, shape, mesh, device="cpu")
    out[f"{arch}/{shape}"] = {"profile": cell.ctx.profile,
                              **dryrun.count_step(cell)}
dist.destroy_process_group()

tag = sys.argv[2]
rc = {}
for name, argv in (
        ("ok", ["--arch", "whisper-small", "--shape", "decode_32k",
                "--tag", tag]),
        ("na", ["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                "--tag", tag])):
    try:
        dryrun.main(argv, device="cpu")
        rc[name] = 0
    except SystemExit as e:
        rc[name] = e.code
def fail(*a, **k):
    raise RuntimeError("a cell that fails")
dryrun.build_cell = fail
try:
    dryrun.main(["--arch", "whisper-small", "--shape", "train_4k", "--tag",
                 tag], device="cpu")
    rc["fail"] = 0
except SystemExit as e:
    rc["fail"] = e.code
out["rc"] = rc
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun-full")
    tag = f"test-{os.getpid()}"
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", _FULL, str(tmp / "out.json"),
                        tag], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-4000:]
    from repro_torch.launch import dryrun
    records = dryrun.ART_DIR.parent / f"dryrun_{tag}"
    yield json.loads((tmp / "out.json").read_text()), records, p.stdout
    import shutil
    shutil.rmtree(records, ignore_errors=True)


def test_fsdp_computes_nothing_twice(full):
    out, _, _ = full
    one, many = out["one_device"], out["tinyllama-1.1b/train_4k"]
    assert one["profile"] == many["profile"] == "fsdp"
    assert abs(many["flops"] * 256 / one["flops"] - 1) < 1e-3
    assert many["memory"]["argument_bytes"] > 0


def test_expert_parallel_decode_at_full_size(full):
    out, _, _ = full
    rec = out["qwen2-moe-a2.7b/decode_32k"]
    assert rec["profile"] == "tp"
    assert rec["flops"] > 0 and rec["traffic_bytes"] > 0
    assert rec["collectives"].get("all-reduce", 0) > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_main_writes_records_and_exits_one_on_a_failed_cell(full):
    out, records, stdout = full
    assert out["rc"] == {"ok": 0, "na": 0, "fail": 1}
    rec = json.loads((records / "single" /
                      "whisper-small__decode_32k.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256 and rec["profile"] == "tp"
    for key in ("arch", "shape", "mesh", "params", "active_params", "flops",
                "traffic_bytes", "collectives", "memory", "trace_s",
                "total_s"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    bad = json.loads((records / "single" /
                      "whisper-small__train_4k.json").read_text())
    assert not bad["ok"] and "a cell that fails" in bad["error"]
    assert "traceback" in bad
    assert "[n/a] tinyllama-1.1b/long_500k" in stdout
    assert "dry-run done: ok=0 fail=1 skipped-n/a=0" in stdout


def _constrain_rank(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import P, ParallelContext
    from repro_torch.parallel.api import NamedSharding, distribute, local_block
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    ctx = ParallelContext(mesh)
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    x = distribute(full, NamedSharding(mesh, P(None, None, "model")))
    out = []
    for spec in ((None, "model", None), ("model", None, None), (None,)):
        spec = spec + (None,) * (3 - len(spec))
        y = ctx.constrain(x, *spec)
        want = local_block(full, mesh, P(*spec))
        out.append((tuple(y.placements) == tuple(
            NamedSharding(mesh, P(*spec)).placements),
            bool(torch.equal(y.to_local(), want))))
    return np.asarray(out)


def _gather_grad_rank(rank, world):
    from repro_torch.parallel import comm
    w = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = comm.all_gather(w, None, 1)
    (y * (rank + 1)).sum().backward()
    return np.asarray([list(y.shape), w.grad.flatten().tolist()],
                      dtype=object)


def test_all_gather_gradient_is_the_reduce_scatter(tmp_path):
    """`comm.all_gather` under autograd on 2 gloo ranks: each rank's
    gradient is its block of the sum of the ranks' gradients (rank r
    weighs the gathered result by r + 1, so every block sums to 3)."""
    for shape, grad in run_in_processes(_gather_grad_rank, 2,
                                        store_dir=tmp_path,
                                        timeout=RANK_TIMEOUT):
        assert shape == [2, 6] and grad == [3.0] * 6


def test_constrain_redistributes_on_two_ranks(tmp_path):
    """A DTensor split over `model` on its last dim, constrained to
    another split and to replicated: each rank holds its `local_block`."""
    for got in run_in_processes(_constrain_rank, 2, store_dir=tmp_path,
                                timeout=RANK_TIMEOUT):
        assert got.all(), got
