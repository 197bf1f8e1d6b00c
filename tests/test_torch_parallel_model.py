"""The port's model under a `ParallelContext` on a one-device mesh, against
`parallel=None` and the live JAX package under its one-device `Mesh`: the
twin of tests/test_sharding.py:95-106, for the tinyllama and qwen2-moe smoke
configs.

The JAX package draws the parameters (`init_params(PRNGKey(0), float32)`)
and `convert.params_from_reference` carries them into the port. The port's
context sits on a one-rank gloo mesh (`launch.mesh.make_local_mesh(
device="cpu")`, its process group destroyed at teardown), the reference's
on `Mesh(jax.devices()[:1], ("data", "model"))`. On the same inputs, made
from a seed with numpy:

- `loss_fn` and its gradients with the context equal `parallel=None`'s bit
  for bit, and the reference's under its context at the tolerances of
  tests/test_torch_train_grads.py (loss rtol 1e-5; gradients rtol 2e-4,
  atol 2e-5);
- `prefill_step`'s logits and a run of `decode_step`s in float32 caches
  equal `parallel=None`'s bit for bit and the reference's at rtol 1e-4,
  atol 1e-5 (tests/test_torch_models.py);
- `LMServer(parallel=ctx).generate` gives `parallel=None`'s greedy tokens
  and the reference's `LMServer(parallel=ctx)`'s;

and on a mesh of more than one device `forward` runs (the dry run's
DTensors) while `LMServer` refuses it, and `make_production_mesh` raises
without its 256 ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.configs as rc
import repro.models as rmod
from repro.parallel.api import ParallelContext as RefContext
from repro.serving.engine import LMServer as RefLMServer
from repro_torch import models as pmod
from repro_torch.convert import params_from_reference
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.parallel import ParallelContext
from repro_torch.serving.engine import LMServer
from test_torch_models import (_assert_close, _grow, _inputs, _port_cache,
                               DECODE_STEPS, S)
from test_torch_train_grads import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                    assert_trees_close, batches, port_paths,
                                    ref_paths)
from repro_torch.training.accumulate import value_and_grad

ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b")
NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ctx():
    """(the port's context on a one-rank gloo mesh, the reference's on its
    one-device mesh)."""
    mesh = make_local_mesh(device="cpu")
    ref_mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    yield ParallelContext(mesh), RefContext(ref_mesh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    out = {}

    def get(arch):
        if arch not in out:
            cfg = rc.get_smoke_config(arch)
            params = rmod.init_params(cfg, jax.random.PRNGKey(0),
                                      dtype=jnp.float32)
            out[arch] = (cfg, params, params_from_reference(params, cfg,
                                                            "cpu"))
        return out[arch]
    return get


def _port_grad(model, cfg, batch, parallel):
    return value_and_grad(
        lambda p, b: pmod.loss_fn(p, cfg, b, parallel=parallel), model,
        batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_under_a_one_device_mesh(arch, ctx, models):
    pctx, rctx = ctx
    cfg, rparams, tparams = models(arch)
    rb, pb = batches(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rmod.loss_fn(p, cfg, b, parallel=rctx),
        has_aux=True))(rparams, rb)
    (loss, _), grads = _port_grad(tparams, cfg, pb, pctx)
    (loss0, _), grads0 = _port_grad(tparams, cfg, pb, None)
    assert float(loss) == float(loss0)
    got, plain = port_paths(grads), port_paths(grads0)
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    assert_trees_close(got, ref_paths(rgrads), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_under_a_one_device_mesh(arch, ctx, models):
    pctx, rctx = ctx
    cfg, rparams, tparams = models(arch)
    rb, pb = _inputs(cfg)
    rl, _ = jax.jit(lambda p, b: rmod.prefill_step(p, cfg, b,
                                                   parallel=rctx))(rparams,
                                                                   rb)
    pl, _ = pmod.prefill_step(tparams, cfg, pb, parallel=pctx)
    pl0, _ = pmod.prefill_step(tparams, cfg, pb)
    assert torch.equal(pl, pl0)
    _assert_close(pl, rl, "prefill logits")

    half = S // 2
    rb0, _ = _inputs(cfg, half)
    _, rcache = rmod.prefill_step(rparams, cfg, rb0)
    rcache = _grow(rcache, rmod.init_cache(cfg, rb0["tokens"].shape[0], S,
                                           dtype=jnp.float32))
    pcache = pcache0 = _port_cache(cfg, rcache)
    ref_decode = jax.jit(lambda p, t, c, i: rmod.decode_step(
        p, cfg, t, c, i, parallel=rctx))
    for i in range(half, half + DECODE_STEPS):
        tok = pb["tokens"][:, i:i + 1]
        rl, rcache = ref_decode(rparams, rb["tokens"][:, i:i + 1], rcache,
                                jnp.int32(i))
        pl, pcache = pmod.decode_step(tparams, cfg, tok, pcache, i,
                                      parallel=pctx)
        pl0, pcache0 = pmod.decode_step(tparams, cfg, tok, pcache0, i)
        assert torch.equal(pl, pl0), i
        _assert_close(pl, rl, f"decode logits at {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_server_under_a_one_device_mesh(arch, ctx, models):
    pctx, rctx = ctx
    cfg, rparams, tparams = models(arch)
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = RefLMServer(rparams, cfg, max_len=32, parallel=rctx).generate(
        prompts, new_tokens=NEW)
    got = LMServer(tparams, cfg, max_len=32, parallel=pctx).generate(
        prompts, new_tokens=NEW)
    plain = LMServer(tparams, cfg, max_len=32).generate(prompts,
                                                       new_tokens=NEW)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


class _ShapeOnly:
    def __init__(self, shape):
        self.shape = shape


def test_forward_on_a_larger_mesh_waits_for_the_dry_run(models):
    """The guard has moved: `forward` on a mesh of more than one device
    runs the model (on DTensors, tests/test_torch_dryrun*.py), so plain
    tensors reach `constrain`, which refuses them; `LMServer` still refuses
    the mesh, and `make_production_mesh` its missing ranks."""
    cfg, _, tparams = models("tinyllama-1.1b")
    big = ParallelContext(_ShapeOnly({"data": 2, "model": 2}))
    with pytest.raises(TypeError, match="needs a DTensor"):
        pmod.loss_fn(tparams, cfg, {"tokens": torch.ones(
            (2, 8), dtype=torch.long)}, parallel=big)
    with pytest.raises(NotImplementedError, match="real ranks"):
        LMServer(tparams, cfg, max_len=16, parallel=big).generate(
            np.ones((2, 4), np.int32), new_tokens=2)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh()
