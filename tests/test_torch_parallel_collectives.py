"""The port's placements and collectives in gloo processes on the CPU,
against the live JAX package on 8 host devices.

The port's side runs in ranks of one gloo process group
(`launch.mesh.run_in_processes`, each call killed after RANK_TIMEOUT s);
the reference's in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8, as
tests/test_pipeline_accum.py:60-66 runs it. Inputs are made with numpy
from a seed and fed to both.

- placements: for specs with ("pod", "data"), ("data", "model") and
  ("pod", "data", "model") entries on (2, 2) and (2, 2, 2) meshes, each
  rank's block of a DTensor made by `torch.distributed.tensor.
  distribute_tensor` and by the port's `distribute` (no communication)
  is the block `NamedSharding(...).devices_indices_map(shape)` gives the
  device at the same mesh coordinate;
- `gpipe`, 4 stages over a 4-rank `pod` axis (the twin of
  tests/test_pipeline_accum.py:33-57): equal to the reference's within
  1e-5 and to the sequential stack within 1e-5;
- `compressed_psum` over a 4-rank `data` axis: the reference's under
  `shard_map`, bit for bit, on every rank;
- `ParallelContext.constrain` and `constrain_tokens_major` on a 4-rank
  (data 2, model 2) mesh redistribute a DTensor to the spec's
  placements, each rank's block equal to `local_block` of the whole;
- `checkpoint.restore(shardings=)`: the twin of
  tests/test_pipeline_accum.py:69-83 on a one-rank gloo mesh, and a
  checkpoint the reference saved restored onto a 2-rank (data 1, model 2)
  mesh, each rank's block equal to its slice of the saved array; in 2
  ranks that each saved a file, a shardings tree with no sharding in it
  reads each rank's own file, and one with a sharding reads process 0's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_local_mesh, run_in_processes
from repro_torch.parallel import P
from repro_torch.parallel.api import NamedSharding

SRC = str(Path(__file__).resolve().parent.parent / "src")
RANK_TIMEOUT = 120
# mesh shape -> specs and the global shape each is laid on
PLACEMENTS = {
    (2, 2): [((8, 12), P(("data", "model"), None)),
             ((8, 12), P(None, ("data", "model"))),
             ((8, 12), P("data", "model")),
             ((8, 12), P("model", None)),
             ((4, 6, 8), P(None, "data", "model")),
             ((8, 12), P())],
    (2, 2, 2): [((8, 12), P(("pod", "data"), None)),
                ((8, 12), P(("pod", "data"), "model")),
                ((8, 12), P(None, ("data", "model"))),
                ((16, 4), P(("pod", "data", "model"), None)),
                ((4, 8), P("pod", ("data", "model"))),
                ((4, 6, 8), P(("pod", "data"), None, "model"))]}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
PIPE_S, PIPE_B, PIPE_D, PIPE_MICRO = 4, 8, 16, 4
PSUM_SHAPE = (4, 64, 48)

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.parallel.pipeline import gpipe
from repro.training import checkpoint as ck
from repro.training.compression import compressed_psum

args = json.load(open(sys.argv[1]))
inp = np.load(args["inputs"])
out = {}
devs = np.asarray(jax.devices())
for key, specs in args["placements"].items():
    shape = tuple(json.loads(key))
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                tuple(args["axes"][str(len(shape))]))
    for i, (gshape, entries) in enumerate(specs):
        entries = [tuple(e) if isinstance(e, list) else e for e in entries]
        idx = NamedSharding(mesh, P(*entries)).devices_indices_map(
            tuple(gshape))
        blocks = [[[s.indices(n)[0], s.indices(n)[1]]
                   for s, n in zip(idx[d], gshape)]
                  for d in mesh.devices.reshape(-1)]
        out[f"place/{key}/{i}"] = np.asarray(blocks)

pod = Mesh(devs[:4], ("pod",))
W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])
out["gpipe"] = np.asarray(gpipe(lambda w, h: jnp.tanh(h @ w), W, x,
                                n_micro=args["n_micro"], axis="pod",
                                mesh=pod))

data = Mesh(devs[:4], ("data",))
psum = jax.shard_map(lambda g: compressed_psum(g[0], "data"), mesh=data,
                     in_specs=P("data"), out_specs=P(), check_vma=False)
out["psum"] = np.asarray(psum(jnp.asarray(inp["G"])))

ck.save(args["ckpt"], 3, {"table": jnp.asarray(inp["table"]),
                          "wq": jnp.asarray(inp["wq"])})
np.savez(args["out"], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"W": rng.normal(0, 0.3, (PIPE_S, PIPE_D, PIPE_D)
                            ).astype(np.float32),
            "x": rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32),
            "G": rng.normal(size=PSUM_SHAPE).astype(np.float32),
            "table": rng.normal(size=(16, 8)).astype(np.float32),
            "wq": rng.normal(size=(8, 12)).astype(np.float32)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def reference(work):
    """The reference's results on 8 host devices, and its checkpoint."""
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    args = {"inputs": str(work / "inputs.npz"), "out": str(work / "ref.npz"),
            "ckpt": str(work / "ref_ckpt"), "n_micro": PIPE_MICRO,
            "axes": {str(k): v for k, v in AXES.items()},
            "placements": {json.dumps(list(k)): [[list(s), list(p)]
                                                 for s, p in v]
                           for k, v in PLACEMENTS.items()}}
    (work / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(work / "args.json")], env=env,
                       capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(work / "ref.npz") as f:
        return dict(f), inputs


# ---------------------------------------------------------------------------
# rank functions (module level: the spawned ranks import them)


def _placement_rank(rank, world, shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.api import distribute
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES[len(shape)])
    blocks = []
    for gshape, spec in PLACEMENTS[shape]:
        full = torch.arange(int(np.prod(gshape)),
                            dtype=torch.float32).reshape(gshape)
        sharding = NamedSharding(mesh, spec)
        scattered = distribute_tensor(full, mesh, sharding.placements)
        mine = distribute(full, sharding)
        local = scattered.to_local()
        assert torch.equal(local, mine.to_local())
        assert tuple(mine.shape) == gshape
        # the block's first element names its offset in every dim
        first = int(local.reshape(-1)[0]) if local.numel() else 0
        offset = np.unravel_index(first, gshape)
        blocks.append([[int(o), int(o) + n]
                       for o, n in zip(offset, local.shape)])
        assert torch.equal(local, full[tuple(slice(a, b)
                                             for a, b in blocks[-1])])
    return mesh.get_coordinate(), blocks


def _pipe_and_psum_rank(rank, world, inputs):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.training.compression import compressed_psum
    torch.set_num_threads(1)
    pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    y = gpipe(lambda w, h: torch.tanh(h @ w), torch.as_tensor(inputs["W"]),
              torch.as_tensor(inputs["x"]), PIPE_MICRO, axis="pod",
              mesh=pod)
    data = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = torch.as_tensor(inputs["G"][rank])
    s = compressed_psum(g, data.get_group("data"))
    return (y.numpy(), s.numpy(),
            comm.transport(pod.get_group("pod"), y.device))


def _restore_rank(rank, world, ckpt):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import checkpoint as ck
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    target = {"table": torch.zeros(16, 8), "wq": torch.zeros(8, 12)}
    shd = {"table": NamedSharding(mesh, P("model", None)),
           "wq": NamedSharding(mesh, P(None, "model"))}
    tree, step = ck.restore(ckpt, target, shardings=shd, device="cpu")
    return step, {k: (tuple(v.placements), v.to_local().numpy(),
                      tuple(v.shape)) for k, v in tree.items()}


def _constrain_rank(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel import ParallelContext
    from repro_torch.parallel.api import local_block
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    ctx = ParallelContext(mesh)
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    x = distribute_tensor(full, mesh, ctx.sharding(P()).placements)
    out = []
    for spec, y in (
            (P(None, None, "model"), ctx.constrain(x, None, None, "model")),
            (P("data", "model", None), ctx.constrain_tokens_major(x, 4)),
            (P(("data", "model"), None, None),
             ctx.constrain(x, ("data", "model"), None, None))):
        out.append((tuple(y.placements) == ctx.sharding(spec).placements,
                    torch.equal(y.to_local(),
                                local_block(full, mesh, spec)),
                    torch.equal(y.full_tensor(), full)))
    return out


def _restore_own_file_rank(rank, world, ckpt):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import checkpoint as ck
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    ck.save(ckpt, 1, {"w": torch.full((2, 4), float(rank))})
    dist.barrier()
    target = {"w": torch.zeros(2, 4)}
    own, _ = ck.restore(ckpt, target, shardings={"w": None}, device="cpu")
    first, _ = ck.restore(ckpt, target, device="cpu", shardings={
        "w": NamedSharding(mesh, P(None, "model"))})
    return float(own["w"].max()), float(first["w"].full_tensor().max())


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(PLACEMENTS))
def test_placements_equal_devices_indices_map(shape, reference, work):
    ref, _ = reference
    got = run_in_processes(_placement_rank, int(np.prod(shape)), shape,
                           store_dir=work, timeout=RANK_TIMEOUT)
    key = json.dumps(list(shape))
    for i, (gshape, spec) in enumerate(PLACEMENTS[shape]):
        want = ref[f"place/{key}/{i}"]
        for coord, blocks in got:
            lin = int(np.ravel_multi_index(tuple(coord), shape))
            assert blocks[i] == want[lin].tolist(), (spec, coord)


@pytest.fixture(scope="module")
def pipe_and_psum(reference, work):
    _, inputs = reference
    return run_in_processes(_pipe_and_psum_rank, 4, inputs, store_dir=work,
                            timeout=RANK_TIMEOUT)


def test_gpipe_matches_the_reference_and_the_sequential_stack(
        reference, pipe_and_psum):
    ref, inputs = reference
    seq = torch.as_tensor(inputs["x"])
    for w in torch.as_tensor(inputs["W"]):
        seq = torch.tanh(seq @ w)
    for y, _, how in pipe_and_psum:
        assert how == "gloo"
        np.testing.assert_allclose(y, ref["gpipe"], rtol=1e-5, atol=1e-5)
        assert float(np.abs(y - seq.numpy()).max()) < 1e-5


def test_compressed_psum_equals_the_reference_bit_for_bit(
        reference, pipe_and_psum):
    ref, _ = reference
    for _, s, _ in pipe_and_psum:
        np.testing.assert_array_equal(s, ref["psum"])


@pytest.fixture
def local_mesh():
    mesh = make_local_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_restore_onto_a_one_rank_mesh(local_mesh, tmp_path):
    """The twin of tests/test_pipeline_accum.py:69-83."""
    from repro_torch.training import checkpoint as ck
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    ck.save(tmp_path, 1, tree)
    shd = {"w": NamedSharding(local_mesh, P("data", None))}
    restored, step = ck.restore(tmp_path, tree, shardings=shd, device="cpu")
    assert step == 1
    np.testing.assert_allclose(restored["w"].full_tensor().numpy(),
                               np.arange(16).reshape(4, 4))
    assert restored["w"].placements == shd["w"].placements
    assert restored["w"].device_mesh == local_mesh


def test_restore_a_reference_checkpoint_onto_two_ranks(reference, work):
    _, inputs = reference
    got = run_in_processes(_restore_rank, 2, str(work / "ref_ckpt"),
                           store_dir=work, timeout=RANK_TIMEOUT)
    for rank, (step, leaves) in enumerate(got):
        assert step == 3
        _, table, shape = leaves["table"]
        assert shape == (16, 8)
        np.testing.assert_array_equal(table,
                                      inputs["table"][8 * rank:8 * rank + 8])
        _, wq, shape = leaves["wq"]
        assert shape == (8, 12)
        np.testing.assert_array_equal(wq, inputs["wq"][:, 6 * rank:6 * rank
                                                       + 6])


def test_constrain_redistributes_a_dtensor(work):
    """On (data 2, model 2), constrain and constrain_tokens_major (2d
    profile, sequence over `model`) lay a replicated DTensor out as the
    spec says: the placements are the spec's and each rank holds its
    `local_block`."""
    for rank_out in run_in_processes(_constrain_rank, 4, store_dir=work,
                                     timeout=RANK_TIMEOUT):
        assert rank_out == [(True, True, True)] * 3, rank_out


def test_restore_reads_process_zero_only_when_a_leaf_is_placed(tmp_path):
    got = run_in_processes(_restore_own_file_rank, 2, str(tmp_path / "ck"),
                           store_dir=tmp_path, timeout=RANK_TIMEOUT)
    assert got == [(0.0, 0.0), (1.0, 0.0)], got
