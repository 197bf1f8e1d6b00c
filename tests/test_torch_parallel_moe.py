"""The port's expert-parallel MoE in gloo processes on the CPU, against the
live JAX package's `apply_moe` under `shard_map` on host devices.

For the qwen2-moe and jamba smoke configs, on a (data 1, model 2) mesh in 2
ranks and a (data 2, model 2) mesh in 4 (`launch.mesh.run_in_processes`,
killed after RANK_TIMEOUT s), with and without `gather_quant`: the
reference draws the MoE layer's parameters (`init_moe(PRNGKey(0),
float32)`) and runs `apply_moe` with a `ParallelContext` on a mesh of the
same shape over 4 host devices (a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=4); the port's ranks run
`apply_moe` on the same parameters and tokens (made with numpy from a
seed). Each rank's block of the output, and `aux`, equal the reference's
within rtol 1e-5, atol 1e-5. They also equal the port's local path on that
rank's data shard (the capacity is the data shard's), on fp8-rounded
expert weights where `gather_quant` gathers them.
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
RANK_TIMEOUT = 120
ARCHS = ("qwen2-moe-a2.7b", "jamba-v0.1-52b")
MESHES = {"model2": (1, 2), "data2-model2": (2, 2)}
B, S = 4, 16
TOL = 1e-5

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import moe as MOE
from repro.parallel.api import ParallelContext

args = json.load(open(sys.argv[1]))
out = {}
devs = np.asarray(jax.devices())
for arch in args["archs"]:
    cfg = get_smoke_config(arch)
    p = MOE.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    flat = {"router": p["router"], "wi": p["wi"], "wg": p["wg"],
            "wo": p["wo"]}
    flat.update({f"shared/{k}": v for k, v in p.get("shared", {}).items()})
    x = np.random.default_rng(1).normal(
        size=(args["B"], args["S"], cfg.d_model)).astype(np.float32)
    out[f"{arch}/x"] = x
    out.update({f"{arch}/p/{k}": np.asarray(v) for k, v in flat.items()})
    for name, shape in args["meshes"].items():
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                    ("data", "model"))
        for quant in (False, True):
            ctx = ParallelContext(mesh, gather_quant=quant)
            y, aux = jax.jit(lambda p, x: MOE.apply_moe(
                p, x, cfg, parallel=ctx))(p, jnp.asarray(x))
            out[f"{arch}/{name}/{quant}/y"] = np.asarray(y)
            out[f"{arch}/{name}/{quant}/aux"] = np.asarray(aux)
np.savez(args["out"], **out)
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("moe")


@pytest.fixture(scope="module")
def reference(work):
    args = {"archs": ARCHS, "meshes": MESHES, "B": B, "S": S,
            "out": str(work / "ref.npz")}
    (work / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(work / "args.json")], env=env,
                       capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(work / "ref.npz") as f:
        return dict(f)


def _params(ref, arch):
    """The reference's MoE parameters as the port's nested dict (of numpy
    arrays: the ranks make their tensors)."""
    pre = f"{arch}/p/"
    p = {}
    for k, v in ref.items():
        if k.startswith(pre):
            name = k[len(pre):]
            node = p.setdefault("shared", {}) if name.startswith(
                "shared/") else p
            node[name.split("/")[-1]] = v
    return p


def _moe_rank(rank, world, shape, cases):
    """Every (arch, quant) case on this rank: (its block of y, aux, the
    local path on its data shard)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import ParallelContext
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    for (arch, quant), (p, x) in cases.items():
        cfg = get_smoke_config(arch)
        ctx = ParallelContext(mesh, gather_quant=quant)
        p = {k: ({n: torch.as_tensor(a) for n, a in v.items()}
                 if isinstance(v, dict) else torch.as_tensor(v))
             for k, v in p.items()}
        x = torch.as_tensor(x)
        y, aux = MOE.apply_moe(p, x, cfg, parallel=ctx)
        local = dict(p)
        w = ctx.moe_weight_axes(cfg)
        if quant and (w["d_ff"] or w["d_model"]):
            local.update({k: p[k].to(torch.float8_e4m3fn).float()
                          for k in ("wi", "wg", "wo")})
        shards = x.chunk(shape[0])
        y_loc, _ = MOE.apply_moe(local, shards[mesh.get_local_rank("data")],
                                 cfg)
        aux_loc = torch.stack([MOE.apply_moe(local, xs, cfg)[1]
                               for xs in shards]).mean()
        out[arch, quant] = (mesh.get_coordinate(), y.to_local().numpy(),
                            float(aux.to_local()), y_loc.numpy(),
                            float(aux_loc), tuple(y.shape))
    return out


@pytest.fixture(scope="module")
def port(reference, work):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            shape = MESHES[mesh]
            cases = {(arch, q): (_params(reference, arch),
                                 reference[f"{arch}/x"])
                     for arch in ARCHS for q in (False, True)}
            runs[mesh] = run_in_processes(
                _moe_rank, int(np.prod(shape)), shape, cases,
                store_dir=work, timeout=RANK_TIMEOUT)
        return runs[mesh]
    return get


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "fp8-gather"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_moe_equals_the_reference(arch, mesh, quant,
                                                  reference, port):
    shape = MESHES[mesh]
    y_ref = reference[f"{arch}/{mesh}/{quant}/y"]
    aux_ref = reference[f"{arch}/{mesh}/{quant}/aux"]
    for out in port(mesh):
        coord, y, aux, y_loc, aux_loc, gshape = out[arch, quant]
        assert gshape == (B, S, y_ref.shape[-1])
        block = y_ref[np.array_split(np.arange(B), shape[0])[coord[0]]]
        np.testing.assert_allclose(y, block, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(aux, aux_ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y, y_loc, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(aux, aux_loc, rtol=TOL, atol=TOL)
