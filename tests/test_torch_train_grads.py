"""The port's training loss and its gradients held against the live JAX
package's, for the smoke configs of the dense, audio and vision families
(`DENSE`; tests/test_torch_train_grads_moe_ssm.py runs the same check on
the rest of `ARCH_IDS`).

The JAX package draws the parameters (`init_params(PRNGKey(0), float32)`)
and `convert.params_from_reference` carries them into the port. On the
same tokens (frames and M-RoPE positions where the family takes them),
made from a seed with numpy:

- `models.loss_fn` equals the reference's `loss_fn` at rtol 1e-5;
- every gradient leaf of `training.accumulate.value_and_grad`, stacked
  into the reference's tree (`reference_tree`), equals `jax.grad`'s leaf
  of the same path and shape at rtol 2e-4, atol 2e-5, the tolerance of
  tests/test_pipeline_accum.py:31;
- the port's gradients under `remat_policy="full"` and `"dots"` are bit
  for bit its gradients without remat: recomputation on the CPU repeats
  the same operations on the same values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
from repro_torch.convert import params_from_reference
from repro_torch.models import loss_fn
from repro_torch.training.accumulate import value_and_grad
from repro_torch.training.tree import tree_items

# the smoke configs this file checks; the MoE, SSM and hybrid ones are in
# tests/test_torch_train_grads_moe_ssm.py
DENSE = ("tinyllama-1.1b", "stablelm-3b", "chatglm3-6b", "stablelm-12b",
         "whisper-small", "qwen2-vl-2b")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def batches(cfg, b=B, s=S, seed=0):
    """(reference batch, port batch) of the same arrays."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(1, cfg.vocab_size, (b, s))
              .astype(np.int32)}
    if cfg.frontend == "audio_stub":
        arrays["frames"] = rng.normal(0, 0.1, (b, cfg.num_frames,
                                               cfg.d_model)).astype(
                                                   np.float32)
    if cfg.rope_variant == "mrope":
        arrays["mrope_positions"] = np.broadcast_to(
            np.arange(s)[None, None], (3, b, s)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in arrays.items()})


def ref_paths(tree):
    """A reference tree as {"a/b/c": numpy array}."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(jnp.asarray(v, jnp.float32))
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_paths(tree):
    return {"/".join(map(str, p)): v.detach().float().numpy()
            for p, v in tree_items(tree)}


def assert_trees_close(got, want, rtol, atol):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=k)


_ref_grad = jax.jit(jax.value_and_grad(
    lambda p, cfg, b, remat: rmod.loss_fn(p, cfg, b, remat_policy=remat),
    has_aux=True), static_argnums=(1, 3))


def port_grad(model, cfg, batch, remat="none"):
    return value_and_grad(
        lambda p, b: loss_fn(p, cfg, b, remat_policy=remat), model, batch)


def check_loss_and_grads(arch):
    cfg = rc.get_smoke_config(arch)
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rb, pb = batches(cfg)
    (rloss, raux), rgrads = _ref_grad(params, cfg, rb, "none")
    model = params_from_reference(params, cfg, "cpu")
    (loss, aux), grads = port_grad(model, cfg, pb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"]), float(raux["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["aux"]), float(raux["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    assert_trees_close(port_paths(grads), ref_paths(rgrads), GRAD_RTOL,
                       GRAD_ATOL)

    # remat recomputes the same operations: the same bits
    want = port_paths(grads)
    for remat in ("full", "dots"):
        (rl, _), g = port_grad(model, cfg, pb, remat)
        assert float(rl) == float(loss), remat
        got = port_paths(g)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{remat} {k}")


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_the_reference(arch):
    check_loss_and_grads(arch)


def test_unknown_remat_policy_raises():
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    model = params_from_reference(
        rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32),
        cfg, "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        loss_fn(model, cfg, batches(cfg)[1], remat_policy="everything")
