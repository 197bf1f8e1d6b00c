"""The port's LM server, model steps, loss and gradients on meshes of real
gloo ranks on the CPU, against the live JAX package on host meshes of the
same shapes.

The reference runs in subprocesses with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (several at once, one
per part of the work); it draws the parameters (`init_params(PRNGKey(0),
float32)`, drawn the same way in the test's process for the port) and the
inputs are made with numpy from a seed. The port runs
in `launch.mesh.run_in_processes` gloo ranks, each mesh's ranks started
once for all its cases and killed after RANK_TIMEOUT s. The ranks take
the "gloo-host" transport, as ranks that share one card do (`comm`'s
transport is patched in the ranks so that CPU tensors count as card
tensors): every move of a DTensor goes through `api._dtensor_move`'s
block path and `parallel.comm`, and a dispatch mode counts DTensor's own
collectives, which must not run.

- `LMServer(parallel=ctx).generate`, for all ten smoke configs on
  (data 1, model 2) and (data 2, model 2) under "tp", "2d" (with
  `seq_shard`) and "fsdp", and for tinyllama and kimi on (pod 2, data 2,
  model 2) under "2d": the reference's `LMServer(parallel=ctx)`'s greedy
  tokens, the port's one-device server's, and the same on every rank.
  On (data 2, model 2) under "2d" the same tokens also come from
  DTensor's own transport, and sampled tokens (`temperature > 0`) are
  the same draws on every rank. The MoE configs under "fsdp" shard a
  batch of 4 over (data, model), which the expert-parallel design
  refuses (its tokens are replicated over `model`; the reference's
  shard_map mixes the tokens of different ranks there, ROADMAP C2); with
  a batch of 2 they give the reference's tokens.
- On (data 2, model 2) under "2d", per config: the prefill logits and
  caches, then `decode_step`s with given tokens from the reference's
  prefill cache grown into float32, each step's logits and the final
  caches gathered whole: rtol 1e-4, atol 1e-5 (tests/test_torch_models.py's
  tolerances; the bfloat16 prefill caches to one bfloat16 step plus 1e-5).
- `loss_fn` and its gradients (`value_and_grad`) on (data 2, model 2)
  under "2d" and "fsdp", for tinyllama (batch 4) and qwen2-moe (batch 2,
  so that "fsdp" keeps its tokens off `model`): the reference's under the
  same host mesh at tests/test_torch_train_grads.py's tolerances (loss
  rtol 1e-5; gradients rtol 2e-4, atol 2e-5).
- DTensor's `redistribute` under the "gloo-host" transport (the block
  path) against the same under DTensor's own transport, for every pair of
  placements of {Shard(0), Shard(1), Replicate, Partial} on a (2, 2) mesh,
  on a shape one of whose dims splits unevenly: forward and backward, bit
  for bit (moves to Partial refused by both).
- `LMServer` keeps refusing a mesh with no real ranks: the dry run's
  fake process group here, a shape-only mesh in
  tests/test_torch_parallel_model.py.
"""
import contextlib
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch.mesh import run_in_processes

SRC = str(Path(__file__).resolve().parent.parent / "src")
RANK_TIMEOUT = 600
MESHES = {"model2": (1, 2), "data2-model2": (2, 2),
          "pod2-data2-model2": (2, 2, 2)}
PROFILES = ("tp", "2d", "fsdp")
MOE = ("kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "jamba-v0.1-52b")
B, S, NEW, MAX_LEN = 4, 8, 4, 16
STEPS = 4                        # decode steps of the given-token run
GRAD_CASES = {("tinyllama-1.1b", "2d"): 4, ("tinyllama-1.1b", "fsdp"): 4,
              ("qwen2-moe-a2.7b", "2d"): 2, ("qwen2-moe-a2.7b", "fsdp"): 2}
GRAD_S = 16
TEMPERATURE = 0.8
# tests/test_torch_models.py's and tests/test_torch_train_grads.py's
# tolerances (their modules import the reference, which the ranks need not)
RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 2e-5


def _token_cases():
    """(arch, mesh, profile, batch) of every `generate` run; the MoE
    configs under "fsdp" also with a batch that the data axis alone
    splits."""
    out = []
    for mesh in ("model2", "data2-model2"):
        for profile in PROFILES:
            for arch in ARCH_IDS:
                out.append((arch, mesh, profile, B))
                if arch in MOE and profile == "fsdp":
                    out.append((arch, mesh, profile, MESHES[mesh][0]))
    out += [(arch, "pod2-data2-model2", "2d", B)
            for arch in ("tinyllama-1.1b", "kimi-k2-1t-a32b")]
    return out


TOKEN_CASES = _token_cases()
# the batch split over (data, model) under "fsdp": the expert-parallel
# MoE refuses it
REFUSED = [(arch, mesh, "fsdp", B) for arch in MOE
           for mesh in ("model2", "data2-model2")]


def inputs(arch):
    """The prompts (B, S), the audio frames (or None), the given decode
    tokens (B, STEPS) and the loss batch's tokens, from a seed."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (rng.normal(0, 0.1, (B, cfg.num_frames, cfg.d_model))
              .astype(np.float32) if cfg.frontend == "audio_stub" else None)
    forced = rng.integers(1, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    loss_tokens = rng.integers(1, cfg.vocab_size, (B, GRAD_S)).astype(
        np.int32)
    return prompts, frames, forced, loss_tokens


_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, os.path.dirname(sys.argv[1]))
import repro.models as rmod
from repro.configs import get_smoke_config
from repro.parallel.api import ParallelContext
from repro.serving.engine import LMServer

args = json.load(open(sys.argv[1]))
part = sys.argv[2]
sys.path.insert(0, args["tests"])
from test_torch_parallel_serving import (B, MAX_LEN, NEW, MESHES, STEPS,
                                         GRAD_CASES, inputs)
devs = np.asarray(jax.devices())
out = {}


def mesh_of(name):
    shape = MESHES[name]
    return Mesh(devs[:int(np.prod(shape))].reshape(shape),
                ("pod", "data", "model")[-len(shape):])


def flat(tree, pre):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in kp)
        out[f"{pre}/{k}"] = np.asarray(jnp.asarray(v, jnp.float32))
        out[f"{pre}/{k}:dtype"] = np.asarray(str(v.dtype))


params = {a: rmod.init_params(get_smoke_config(a), jax.random.PRNGKey(0),
                              dtype=jnp.float32) for a in args["archs"]}
for case in args["tokens"]:
    arch, mesh, profile, b = case
    if (profile == "fsdp" and b == B
            and get_smoke_config(arch).moe is not None):
        continue                 # refused by the port: ROADMAP C2
    if part != f"tokens-{profile}":
        continue
    cfg = get_smoke_config(arch)
    prompts, frames, _, _ = inputs(arch)
    ctx = ParallelContext(mesh_of(mesh), profile=profile)
    out["/".join(map(str, case))] = LMServer(
        params[arch], cfg, max_len=MAX_LEN, parallel=ctx).generate(
        prompts[:b], new_tokens=NEW,
        frames=None if frames is None else frames[:b])
if part == "forced":
    ctx = ParallelContext(mesh_of("data2-model2"), profile="2d")
    for arch in args["archs"]:
        cfg = get_smoke_config(arch)
        prompts, frames, forced, _ = inputs(arch)
        batch = {"tokens": jnp.asarray(prompts)}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        if cfg.rope_variant == "mrope":
            batch["mrope_positions"] = jnp.broadcast_to(
                jnp.arange(prompts.shape[1])[None, None],
                (3,) + prompts.shape)
        lg, cache = jax.jit(lambda p, b: rmod.prefill_step(
            p, cfg, b, parallel=ctx))(params[arch], batch)
        out[f"{arch}/prefill/logits"] = np.asarray(lg)
        flat(cache, f"{arch}/prefill/cache")
        big = rmod.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32)
        cache = jax.tree.map(
            lambda d, c: (c if d.shape == c.shape else d.at[tuple(
                slice(0, m) for m in c.shape)].set(c.astype(d.dtype))),
            big, cache)
        flat(cache, f"{arch}/grown")
        step = jax.jit(lambda p, t, c, i, mp: rmod.decode_step(
            p, cfg, t, c, i, parallel=ctx, mrope_positions=mp))
        mp = (jnp.zeros((3, B, 1), jnp.int32)
              if cfg.rope_variant == "mrope" else None)
        for i in range(STEPS):
            lg, cache = step(params[arch], jnp.asarray(forced[:, i:i + 1]),
                             cache, jnp.int32(prompts.shape[1] + i), mp)
            out[f"{arch}/decode/{i}"] = np.asarray(lg)
        flat(cache, f"{arch}/decode/cache")
if part == "grads":
    for arch, profile in {tuple(k.split("|")) for k in args["grads"]}:
        b = args["grads"][f"{arch}|{profile}"]
        cfg = get_smoke_config(arch)
        ctx = ParallelContext(mesh_of("data2-model2"), profile=profile)
        toks = jnp.asarray(inputs(arch)[3][:b])
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, t: rmod.loss_fn(p, cfg, {"tokens": t}, parallel=ctx),
            has_aux=True))(params[arch], toks)
        out[f"{arch}/{profile}/loss"] = np.asarray(loss)
        flat(grads, f"{arch}/{profile}/grad")
tmp = os.path.join(args["out"], part + ".tmp.npz")
np.savez(tmp, **out)
os.replace(tmp, os.path.join(args["out"], part + ".npz"))
"""

PARTS = ("tokens-tp", "tokens-2d", "tokens-fsdp", "forced", "grads")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("serving")


def _start_reference(work, part):
    args = {"archs": list(ARCH_IDS), "out": str(work),
            "tests": str(Path(__file__).resolve().parent),
            "tokens": TOKEN_CASES,
            "grads": {f"{a}|{p}": b for (a, p), b in GRAD_CASES.items()}}
    (work / "args.json").write_text(json.dumps(args))
    (work / "script.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(work / "script.py"), str(work / "args.json"),
         part], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc, work, part):
    text, _ = proc.communicate(timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, text[-4000:]
    with np.load(work / f"{part}.npz") as f:
        return dict(f)


def _tree(flat, pre):
    """{path: array} entries under `pre` as nested dicts."""
    tree = {}
    for k, v in flat.items():
        if k.startswith(pre + "/") and not k.endswith(":dtype"):
            node = tree
            *parents, name = k[len(pre) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = v
    return tree


# ---------------------------------------------------------------------------
# the ranks


@contextlib.contextmanager
def _gloo_as_host():
    """CPU tensors under gloo take the "gloo-host" transport, as card
    tensors do."""
    from repro_torch.parallel import comm
    real = comm.transport
    comm.transport = lambda group, device: (
        "gloo-host" if real(group, device) == "gloo" else
        real(group, device))
    try:
        yield
    finally:
        comm.transport = real


def _watch_grad_off_moves(seen):
    """From here on, records in `seen` the shape of each DTensor that
    DTensor's `redistribute` moves while it asks for a gradient with
    gradients off: torch 2.11's autograd then fails (no sharding rule for
    `detach_`)."""
    import torch
    from torch.distributed.tensor import DTensor
    real = DTensor.redistribute

    def watched(self, *args, **kwargs):
        if self.requires_grad and not torch.is_grad_enabled():
            seen.append(tuple(self.shape))
        return real(self, *args, **kwargs)
    DTensor.redistribute = watched


def _counting_mode(count):
    """A dispatch mode counting DTensor's own (functional) collectives
    into `count`: it sees the local ops a DTensor op runs."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor runs, then its locals
            if func.namespace == "_c10d_functional":
                count[str(func)] = count.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))
    return Mode()


def _whole_np(t):
    from repro_torch.serving.engine import whole
    return whole(t).float().numpy()


def _cache_np(cache):
    return [{k: {n: _whole_np(t) for n, t in v.items()}
             for k, v in c.items()} for c in cache]


def _per_layer(cfg, stacked):
    """The reference's stacked cache (nested dicts of numpy) as the port's
    per-layer list: layer i is stage i // stage_len, position i %
    stage_len."""
    import torch
    from repro_torch.models.transformer import num_blocks, stage_len
    sl = stage_len(cfg)
    return [{k: {n: torch.as_tensor(a[i // sl]) for n, a in v.items()}
             for k, v in stacked[f"pos{i % sl}"].items()}
            for i in range(num_blocks(cfg))]


def _wait_for(path, pre):
    """{arch: the tree under `arch/pre`} of the reference's npz at `path`,
    once its subprocess has written it."""
    import time
    deadline = time.monotonic() + RANK_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the reference did not write {path}")
        time.sleep(0.2)
    with np.load(path) as f:
        flat = dict(f)
    return {a: _tree(flat, f"{a}/{pre}") for a in ARCH_IDS}


def _serving_rank(rank, world, shape, params, token_cases, forced_path,
                  grad_cases, redistribute_shapes):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.convert import params_from_reference, place_model
    from repro_torch.models import loss_fn
    from repro_torch.parallel import ParallelContext, comm
    from repro_torch.parallel import sharding as sh
    from repro_torch.serving.engine import LMServer, place_batch
    from repro_torch.training.accumulate import value_and_grad
    from repro_torch.training.tree import tree_items
    torch.set_num_threads(1)
    names = ("pod", "data", "model")[-len(shape):]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    out = {"coord": mesh.get_coordinate()}
    models = {a: params_from_reference(p, get_smoke_config(a), "cpu")
              for a, p in params.items()}
    out["grad_off_moves"] = []
    _watch_grad_off_moves(out["grad_off_moves"])
    # DTensor's own transport, on the CPU
    for case in token_cases:
        if case[1:3] == ("data2-model2", "2d"):
            arch, b = case[0], case[3]
            prompts, frames, _, _ = inputs(arch)
            out[case + ("dtensor",)] = LMServer(
                models[arch], get_smoke_config(arch), max_len=MAX_LEN,
                parallel=ParallelContext(mesh)).generate(
                prompts[:b], NEW, frames=None if frames is None
                else frames[:b])
    if redistribute_shapes:
        out["redistribute"] = _redistribute_pairs(mesh, redistribute_shapes)
    # the card's transport from here on
    comm.reset_host_stats()
    count, ones = {}, {}
    with _gloo_as_host(), _counting_mode(count):
        for case in token_cases:
            arch, _, profile, b = case
            cfg = get_smoke_config(arch)
            prompts, frames, _, _ = inputs(arch)
            prompts = prompts[:b]
            frames = None if frames is None else frames[:b]
            ctx = ParallelContext(mesh, profile=profile)
            srv = LMServer(models[arch], cfg, max_len=MAX_LEN, parallel=ctx)
            try:
                got = srv.generate(prompts, NEW, frames=frames)
            except ValueError as e:
                out[case] = ("refused", str(e))
                continue
            if (arch, b) not in ones:      # the one-device server's tokens
                ones[arch, b] = LMServer(models[arch], cfg,
                                         max_len=MAX_LEN).generate(
                    prompts, NEW, frames=frames)
            out[case] = (got, ones[arch, b])
            if case[1:3] == ("data2-model2", "2d"):
                out[case + ("sampled",)] = srv.generate(
                    prompts, NEW, temperature=TEMPERATURE, seed=3,
                    frames=frames)
        if forced_path:
            for arch, tree in _wait_for(forced_path, "grown").items():
                out[arch, "forced"] = _forced(arch, mesh, models[arch], tree)
        for (arch, profile), b in grad_cases.items():
            cfg = get_smoke_config(arch)
            ctx = ParallelContext(mesh, profile=profile)
            placed = place_model(models[arch], sh.param_pspecs(
                ctx, cfg, models[arch]), mesh)
            toks = torch.as_tensor(inputs(arch)[3][:b]).long()
            with implicit_replication():
                batch = place_batch(ctx, cfg, {"tokens": toks})
                (loss, _), grads = value_and_grad(
                    lambda p, bt: loss_fn(p, cfg, bt, parallel=ctx), placed,
                    batch)
                out[arch, profile, "grad"] = (
                    float(_whole_np(loss)),
                    {"/".join(map(str, p)): _whole_np(g)
                     for p, g in tree_items(grads)})
    out["functional_collectives"] = count
    out["transports"] = dict(comm.host_stats["transports"])
    return out


def _forced(arch, mesh, model, grown):
    """On `mesh` under "2d": the prefill's logits and cache, then a
    decode step for each given token from the reference's grown float32
    cache `grown`, each step's logits and the final cache, all gathered
    whole."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.convert import place_cache, place_model
    from repro_torch.models import decode_step, prefill_step
    from repro_torch.parallel import ParallelContext
    from repro_torch.parallel import sharding as sh
    from repro_torch.serving.engine import (_batch, lay_out_cache,
                                            place_batch, zero_cache)
    cfg = get_smoke_config(arch)
    ctx = ParallelContext(mesh, profile="2d")
    prompts, frames, forced, _ = inputs(arch)
    params = place_model(model, sh.param_pspecs(ctx, cfg, model), mesh)
    with torch.inference_mode(), implicit_replication():
        batch = place_batch(ctx, cfg, _batch(cfg, prompts, frames, "cpu"))
        lg, cache = prefill_step(params, cfg, batch, parallel=ctx,
                                 cache=zero_cache(ctx, cfg, B, S))
        prefill = (_whole_np(lg), _cache_np(cache))
        cache = _per_layer(cfg, grown)
        cache = place_cache(cfg, cache, sh.cache_pspecs(ctx, cfg, cache),
                            mesh)
        logits = []
        for i in range(STEPS):
            step = {"tokens": torch.as_tensor(forced[:, i:i + 1]).long()}
            if cfg.rope_variant == "mrope":
                step["mrope_positions"] = torch.zeros((3, B, 1),
                                                      dtype=torch.long)
            step = place_batch(ctx, cfg, step)
            lg, cache = decode_step(params, cfg, step["tokens"], cache,
                                    S + i, parallel=ctx,
                                    mrope_positions=step.get(
                                        "mrope_positions"))
            cache = lay_out_cache(ctx, cfg, cache)
            logits.append(_whole_np(lg))
        return prefill, logits, _cache_np(cache)


def _redistribute_pairs(mesh, shapes):
    """For every pair of placements on every shape: (DTensor's
    `redistribute` under DTensor's own transport, the same under
    "gloo-host"), each (placements, local block, the gradient's placements,
    its local block, whether a move went through the block path) or
    ("refused", the error's type)."""
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.parallel import comm
    opts = (Shard(0), Shard(1), Replicate(), Partial())
    me = torch.distributed.get_rank()
    out = {}
    for shape in shapes:
        gen = torch.Generator().manual_seed(0)
        full = torch.randn(shape, generator=gen)
        gfull = torch.randn(shape, generator=gen)

        def make(t, pl, scale):
            x = distribute_tensor(t, mesh, [Replicate() if p.is_partial()
                                            else p for p in pl])
            if any(p.is_partial() for p in pl):   # each rank its own part
                x = DTensor.from_local(x.to_local() * (1 + scale * me), mesh,
                                       pl, run_check=False, shape=t.shape,
                                       stride=t.stride())
            return x

        for src in itertools.product(opts, repeat=2):
            for dst in itertools.product(opts, repeat=2):
                res = []
                for host in (contextlib.nullcontext, _gloo_as_host):
                    x = make(full, src, 0.37).detach().requires_grad_(True)
                    g = make(gfull, dst, 0.11)
                    moves = comm.host_stats["dtensor_moves"]
                    try:
                        with host():
                            y = x.redistribute(mesh, dst)
                            y.backward(g)
                    except (RuntimeError, ValueError) as e:
                        res.append(("refused", type(e).__name__))
                        continue
                    res.append((tuple(map(str, y.placements)),
                                y.to_local().detach().numpy(),
                                tuple(map(str, x.grad.placements)),
                                x.grad.to_local().numpy(),
                                comm.host_stats["dtensor_moves"] > moves))
                out[shape, str(src), str(dst)] = res
    return out


@pytest.fixture(scope="module")
def runs(work):
    """(each mesh's ranks' results, the reference's parts), the reference's
    parts and the meshes' ranks all running at once."""
    from concurrent.futures import ThreadPoolExecutor
    import jax
    import jax.numpy as jnp
    import repro.configs as rc
    import repro.models as rmod
    procs = {part: _start_reference(work, part) for part in PARTS}
    # the reference's parameters, drawn here as its subprocesses draw them
    params = {a: jax.tree.map(np.asarray, rmod.init_params(
        rc.get_smoke_config(a), jax.random.PRNGKey(0), dtype=jnp.float32))
        for a in ARCH_IDS}
    ref = {}

    def run(mesh):
        shape = MESHES[mesh]
        cases = [c for c in TOKEN_CASES if c[1] == mesh]
        big = mesh == "data2-model2"
        return run_in_processes(
            _serving_rank, int(np.prod(shape)), shape,
            {a: params[a] for a in sorted({c[0] for c in cases})}, cases,
            str(work / "forced.npz") if big else None,
            GRAD_CASES if big else {}, [(8, 5)] if big else [],
            store_dir=work, timeout=RANK_TIMEOUT)

    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {mesh: pool.submit(run, mesh) for mesh in MESHES}
        for part, proc in procs.items():
            ref[part] = _finish(proc, work, part)
        out = {mesh: f.result() for mesh, f in futures.items()}
    return out, ref


def _ref_tokens(ref, case):
    return ref[f"tokens-{case[2]}"]["/".join(map(str, case))]


@pytest.mark.parametrize("case", [c for c in TOKEN_CASES if c not in REFUSED],
                         ids=lambda c: "-".join(map(str, c)))
def test_generate_on_real_ranks_gives_the_references_tokens(case, runs):
    out, ref = runs
    want = _ref_tokens(ref, case)
    assert want.shape == (case[3], NEW)
    for rank in out[case[1]]:
        got, one = rank[case]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(one, want)


@pytest.mark.parametrize("case", REFUSED, ids=lambda c: "-".join(c[:2]))
def test_moe_under_fsdp_refuses_tokens_split_over_model(case, runs):
    """A batch of 4 under "fsdp" is split over (data, model); the
    expert-parallel MoE, whose tokens are replicated over `model`, refuses
    it (the cases of a batch the data axis alone splits are above)."""
    out, _ = runs
    for rank in out[case[1]]:
        what, msg = rank[case]
        assert what == "refused" and "replicated over `model`" in msg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sampling_and_dtensors_own_transport_agree_on_every_rank(arch,
                                                                 runs):
    out, ref = runs
    case = (arch, "data2-model2", "2d", B)
    ranks = out["data2-model2"]
    want = _ref_tokens(ref, case)
    for rank in ranks:
        np.testing.assert_array_equal(rank[case + ("dtensor",)], want)
        np.testing.assert_array_equal(rank[case + ("sampled",)],
                                      ranks[0][case + ("sampled",)])
    assert ranks[0][case + ("sampled",)].shape == (B, NEW)


def test_no_collective_of_dtensors_own_runs_on_the_host_transport(runs):
    out, _ = runs
    for mesh, ranks in out.items():
        for rank in ranks:
            assert rank["functional_collectives"] == {}, mesh
            assert set(rank["transports"]) == {"gloo-host"}, mesh


def test_served_steps_move_no_tensor_that_asks_for_a_gradient(runs):
    """The server runs its steps with gradients off, on parameters that
    ask for one: DTensor's `redistribute` of such a tensor fails under
    torch 2.11 (the card's), so every move of the served steps takes a
    detached tensor (`api._grad_free`)."""
    out, _ = runs
    for mesh, ranks in out.items():
        for rank in ranks:
            assert rank["grad_off_moves"] == [], mesh


def _check_cache(got, ref, pre, what):
    from repro_torch.models.transformer import stage_len
    from test_torch_models import _assert_bf16_close, _assert_close
    cfg = get_smoke_config(what[0])
    sl = stage_len(cfg)
    tree = _tree(ref, pre)
    for i, layer in enumerate(got):
        want = tree[f"pos{i % sl}"]
        assert set(layer) == set(want), (what, i)
        for kind, leaves in layer.items():
            assert set(leaves) == set(want[kind]), (what, i, kind)
            for name, t in leaves.items():
                w = want[kind][name][i // sl]
                dtype = str(ref[f"{pre}/pos{i % sl}/{kind}/{name}:dtype"])
                check = (_assert_bf16_close if dtype == "bfloat16"
                         else _assert_close)
                check(t, w, f"{what} layer {i} {kind}.{name}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_on_real_ranks_equal_the_reference(arch, runs):
    out, ref = runs
    forced = ref["forced"]
    for rank in out["data2-model2"]:
        (pl, pcache), logits, cache = rank[arch, "forced"]
        np.testing.assert_allclose(pl, forced[f"{arch}/prefill/logits"],
                                   rtol=RTOL, atol=ATOL)
        _check_cache(pcache, forced, f"{arch}/prefill/cache",
                     (arch, "prefill"))
        for i, lg in enumerate(logits):
            np.testing.assert_allclose(lg, forced[f"{arch}/decode/{i}"],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"decode step {i}")
        _check_cache(cache, forced, f"{arch}/decode/cache", (arch, "decode"))


@pytest.mark.parametrize("case", sorted(GRAD_CASES),
                         ids=lambda c: "-".join(c))
def test_loss_and_gradients_on_real_ranks_equal_the_reference(case, runs):
    out, ref = runs
    arch, profile = case
    grads = ref["grads"]
    want = {k[len(f"{arch}/{profile}/grad/"):]: v for k, v in grads.items()
            if k.startswith(f"{arch}/{profile}/grad/")
            and not k.endswith(":dtype")}
    for rank in out["data2-model2"]:
        loss, got = rank[arch, profile, "grad"]
        np.testing.assert_allclose(loss, grads[f"{arch}/{profile}/loss"],
                                   rtol=LOSS_RTOL)
        assert set(got) == set(want), set(got) ^ set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)


def test_block_redistribute_equals_dtensors_bit_for_bit(runs):
    """On (8, 5): dim 0 splits evenly over a mesh dim of 2 and over both,
    dim 1 does not."""
    out, _ = runs
    n = 0
    for rank in out["data2-model2"]:
        for (_, src, dst), (theirs, ours) in rank["redistribute"].items():
            n += 1
            assert theirs[0] == ours[0], (src, dst, theirs[0], ours[0])
            if theirs[0] == "refused":
                continue
            assert theirs[0] == ours[0] and theirs[2] == ours[2], (src, dst)
            # the block path ran on "gloo-host" (only), wherever a move is
            assert not theirs[4] and (ours[4] or src == dst), (src, dst)
            np.testing.assert_array_equal(ours[1], theirs[1],
                                          err_msg=f"{src}->{dst}")
            np.testing.assert_array_equal(ours[3], theirs[3],
                                          err_msg=f"{src}->{dst} grad")
    assert n == 4 * 16 * 16


_FAKE_RANKS = r"""
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import init_fake_ranks
from repro_torch.models import init_params
from repro_torch.parallel import ParallelContext
from repro_torch.serving.engine import LMServer

init_fake_ranks(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
cfg = get_smoke_config("tinyllama-1.1b")
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
srv = LMServer(params, cfg, max_len=16, parallel=ParallelContext(mesh))
try:
    srv.generate(torch.ones((2, 4), dtype=torch.int32).numpy(), 2)
except NotImplementedError as e:
    print("refused:", e)
"""


def test_lm_server_refuses_the_dry_runs_fake_ranks():
    """On a fake process group (the dry run's ranks, which compute
    nothing) `generate` raises NotImplementedError naming real ranks and
    the dry run. A fake group needs a process of its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _FAKE_RANKS], env=env,
                       capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "refused:" in r.stdout and "real ranks" in r.stdout \
        and "launch.dryrun" in r.stdout, r.stdout
