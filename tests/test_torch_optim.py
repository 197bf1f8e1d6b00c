"""The port's optimizer, gradient compression and gradient accumulation
held against the live JAX package's.

- `optim.apply_updates` over 5 steps of the same gradients (made from a
  seed with numpy, scaled so that their global norm stays below
  `clip_norm` and the clip scale is exactly 1.0 in both packages) leaves
  the parameters and every state leaf equal to the reference's at rtol
  1e-5, above a floor of 2**-20 of each leaf's largest magnitude for the
  elements whose float32 sums cancel near zero: for the tinyllama smoke config with `for_model`'s defaults, where
  the reference decays the norm scales stacked over stages, and for the
  kimi smoke config with `min_factored_size=1`, where it factors them
  across layers and keeps `m` in bfloat16. There a bfloat16 `m` may round
  to the neighbouring value where the two packages' float32 sums differ in
  their last bit: it is held to one bfloat16 step at the largest magnitude
  the element took over the run (a step's difference decays by b1 and
  stays within the coarsest step it was rounded to), and kimi's parameters
  at rtol 1e-4, atol 1e-6;
- `schedule` and `global_norm` equal the reference's;
- `compression.quantize` gives the reference's int8 codes and scale bit
  for bit, exact halves included (both round half to even), and
  `ef_compress_tree` its gradients and error state over 3 steps;
- `accumulate.accumulated_grads` equals the full batch's gradients and
  the reference's accumulated ones at the gradient tolerance;
- the twins of tests/test_training_checkpoint.py:85 and :97.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
from repro.training import compression as rcomp
from repro.training import optim as roptim
from repro.training.accumulate import accumulated_grads as ref_accumulated
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.models import loss_fn
from repro_torch.training import compression, optim
from repro_torch.training.accumulate import accumulated_grads, value_and_grad
from repro_torch.training.tree import param_tree, tree_items
from test_torch_train_grads import (GRAD_ATOL, GRAD_RTOL, assert_trees_close,
                                    batches, port_paths, ref_paths)

STEPS = 5
RTOL = 1e-5
# a sum of float32 terms that cancels near zero (p - lr * upd, the moving
# average m of gradients that change sign) keeps the rounding of its terms'
# magnitude, not of its result: each leaf's floor is a few float32 steps at
# its largest magnitude
FLOOR = 2.0 ** -20


def _floor(w):
    return FLOOR * float(np.abs(w).max())
BF16_PARAM_RTOL, BF16_PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grad_trees(params, steps, norm=0.5, seed=0):
    """`steps` random gradient trees shaped as the reference's `params`,
    each of global norm `norm`, as (reference trees, port trees)."""
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(params)
    ref, port = [], []
    for _ in range(steps):
        leaves = [rng.normal(size=np.shape(v)).astype(np.float32)
                  for _, v in flat]
        total = np.sqrt(sum(float(np.sum(np.square(x.astype(np.float64))))
                            for x in leaves))
        leaves = [(x * (norm / total)).astype(np.float32) for x in leaves]
        ref.append(jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(x) for x in leaves]))
        tree = {}
        for (kp, _), x in zip(flat, leaves):
            node = tree
            keys = [k.key for k in kp]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = torch.as_tensor(x)
        port.append(tree)
    return ref, port


def _bf16_step(w):
    mag = np.abs(w)
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("arch,overrides", [
    ("tinyllama-1.1b", {}),
    ("kimi-k2-1t-a32b", {"min_factored_size": 1}),
])
def test_apply_updates_equal_the_reference(arch, overrides):
    cfg = rc.get_smoke_config(arch)
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS, **overrides)
    ref_opt, opt = roptim.for_model(cfg, **kw), optim.for_model(cfg, **kw)
    assert opt == optim.OptimizerConfig(**{
        f: getattr(ref_opt, f) for f in ref_opt.__dataclass_fields__})
    model = params_from_reference(params, cfg, "cpu")
    ref_state = roptim.init_state(params, ref_opt)
    state = optim.init_state(model, opt, device="cpu")
    ref_grads, grads = _grad_trees(params, STEPS)
    ref_step = jax.jit(lambda p, g, s: roptim.apply_updates(p, g, s,
                                                            ref_opt))
    peak = {}     # each element's largest magnitude over the run
    for rg, g in zip(ref_grads, grads):
        params, ref_state, rm = ref_step(params, rg, ref_state)
        model, state, m = optim.apply_updates(model, g, state, opt)
        for k, w in ref_paths(ref_state["mu"]).items():
            peak[k] = np.maximum(peak.get(k, 0.0), np.abs(w))
        assert float(rm["grad_norm"]) < opt.clip_norm
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert state["step"].dtype == torch.int32
    assert int(state["step"]) == int(ref_state["step"]) == STEPS

    bf16_m = opt.state_dtype == "bfloat16"
    got = {"/".join(map(str, p)): v for p, v in
           tree_items(params_to_reference(model))}
    want = ref_paths(params)
    assert set(got) == set(want)
    for k, w in want.items():
        if bf16_m:
            np.testing.assert_allclose(got[k], w, rtol=BF16_PARAM_RTOL,
                                       atol=BF16_PARAM_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                       atol=_floor(w), err_msg=k)

    got = port_paths(state["mu"])
    want = ref_paths(ref_state["mu"])
    assert set(got) == set(want), set(got) ^ set(want)
    dtypes = {"/".join(str(k.key) for k in kp): str(v.dtype) for kp, v in
              jax.tree_util.tree_flatten_with_path(ref_state["mu"])[0]}
    for p, v in tree_items(state["mu"]):
        assert str(v.dtype).split(".")[-1] == dtypes["/".join(p)], p
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if dtypes[k] == "bfloat16":
            bad = np.abs(got[k] - w) > _bf16_step(peak[k]) + _floor(w)
            assert not bad.any(), (k, int(bad.sum()))
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=_floor(w),
                                       err_msg=k)
    if arch.startswith("kimi"):
        # the stacked (num_stages, D) norm scales are factored across layers
        assert {"m", "vr", "vc"} == set(
            state["mu"]["stages"]["pos0"]["ln1"]["scale"])


def test_tinyllama_decays_the_stacked_norm_scales():
    """A zero gradient moves only decayed leaves: the norm scales inside
    the stages (rank 2 when stacked) but not final_norm (rank 1)."""
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    model = params_from_reference(
        rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32),
        cfg, "cpu")
    opt = optim.for_model(cfg, lr=1e-3, warmup_steps=1)
    state = optim.init_state(model, opt, device="cpu")
    zeros = {"/".join(map(str, p)): torch.zeros(leaf.shape) for p, leaf in
             tree_items(param_tree(model))}
    grads = {}
    for k, v in zeros.items():
        node = grads
        keys = k.split("/")
        for kk in keys[:-1]:
            node = node.setdefault(kk, {})
        node[keys[-1]] = v
    optim.apply_updates(model, grads, state, opt)
    assert float(model.blocks[0].ln1.scale.detach().max()) < 1.0
    assert float(model.final_norm.scale.detach().min()) == 1.0


def test_schedule_and_global_norm_equal_the_reference():
    opt = optim.OptimizerConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    ref_opt = roptim.OptimizerConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    for s in range(0, 45):
        np.testing.assert_allclose(
            float(optim.schedule(opt, torch.tensor(s, dtype=torch.int32))),
            float(roptim.schedule(ref_opt, jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    np.testing.assert_allclose(
        float(optim.global_norm({"a": torch.as_tensor(tree["a"]),
                                 "b": {"c": torch.as_tensor(tree["b"]["c"])}
                                 })),
        float(roptim.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


def test_adamw_converges_quadratic():
    """The twin of tests/test_training_checkpoint.py:85."""
    opt = optim.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                                total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.init_state(params, opt, device="cpu")
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, state, _ = optim.apply_updates(params, g, state, opt)
    assert float(params["w"].abs().max()) < 0.3


def test_factored_second_moment_tracks_full():
    """The twin of tests/test_training_checkpoint.py:97."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(32, 48)).astype(np.float32))
    pf = {"w": torch.zeros((32, 48))}
    opt_full = optim.OptimizerConfig(lr=0.01, weight_decay=0.0,
                                     factored=False, total_steps=100)
    opt_fac = optim.OptimizerConfig(lr=0.01, weight_decay=0.0, factored=True,
                                    min_factored_size=1, total_steps=100)
    sf = optim.init_state(pf, opt_full, device="cpu")
    sa = optim.init_state(pf, opt_fac, device="cpu")
    assert "vr" in sa["mu"]["w"] and "v" in sf["mu"]["w"]
    p1, p2 = pf, pf
    for _ in range(20):
        p1, sf, _ = optim.apply_updates(p1, {"w": g}, sf, opt_full)
        p2, sa, _ = optim.apply_updates(p2, {"w": g}, sa, opt_fac)
    u1 = p1["w"].numpy().ravel()
    u2 = p2["w"].numpy().ravel()
    corr = np.corrcoef(u1, u2)[0, 1]
    assert corr > 0.75, corr
    assert (np.sign(u1) == np.sign(u2)).mean() > 0.95
    assert float(pf["w"].abs().max()) == 0.0     # the tree is not mutated


def test_quantize_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 0.0, -127.0], np.float32)   # scale == 1.0
    cases = [halves, rng.normal(size=(64, 33)).astype(np.float32),
             (rng.normal(size=(5, 7, 9)) * 1e-6).astype(np.float32),
             np.zeros((4,), np.float32)]
    for g in cases:
        rq, rs = rcomp.quantize(jnp.asarray(g))
        q, s = compression.quantize(torch.as_tensor(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert np.float32(s.item()) == np.float32(rs), (s.item(), rs)
        np.testing.assert_array_equal(
            compression.dequantize(q, s).numpy(),
            np.asarray(rcomp.dequantize(rq, rs)))
    q, _ = compression.quantize(torch.as_tensor(halves))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0, -127]


def test_ef_compress_tree_equals_the_reference():
    rng = np.random.default_rng(1)
    shapes = {"a": (2, 16, 8), "b": {"c": (8,), "d": (3, 5)}}
    ref_e = rcomp.init_error_state(jax.tree.map(jnp.zeros, shapes,
                                                is_leaf=lambda x: isinstance(
                                                    x, tuple)))
    e = compression.init_error_state(
        {"a": torch.zeros(2, 16, 8),
         "b": {"c": torch.zeros(8), "d": torch.zeros(3, 5)}}, device="cpu")
    for _ in range(3):
        g = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
        rg, ref_e = rcomp.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                           ref_e)
        pg, e = compression.ef_compress_tree(
            jax.tree.map(torch.as_tensor, g), e)
        assert port_paths(pg).keys() == ref_paths(rg).keys()
        for k, w in ref_paths(rg).items():
            np.testing.assert_array_equal(port_paths(pg)[k], w, err_msg=k)
        for k, w in ref_paths(ref_e).items():
            np.testing.assert_array_equal(port_paths(e)[k], w, err_msg=k)


def test_accumulated_grads_match_full_batch_and_the_reference():
    """The twin of tests/test_pipeline_accum.py:14-32, and the reference's
    accumulated gradients on the same parameters and batch."""
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = params_from_reference(params, cfg, "cpu")
    rb, pb = batches(cfg, b=4, s=32)

    def port_loss(p, b):
        return loss_fn(p, cfg, b)

    (loss_f, _), g_full = value_and_grad(port_loss, model, pb)
    (loss_a, aux), g_acc = accumulated_grads(port_loss, model, pb, 4)
    np.testing.assert_allclose(float(loss_a), float(loss_f), rtol=1e-5)
    assert set(aux) == {"ce", "aux"}
    assert_trees_close(port_paths(g_acc), port_paths(g_full), GRAD_RTOL,
                       GRAD_ATOL)
    (rloss, _), rg = ref_accumulated(lambda p, b: rmod.loss_fn(p, cfg, b),
                                     params, rb, n_micro=4)
    np.testing.assert_allclose(float(loss_a), float(rloss), rtol=1e-5)
    assert_trees_close(port_paths(g_acc), ref_paths(rg), GRAD_RTOL,
                       GRAD_ATOL)
