"""The port's LM stack (repro_torch.configs, repro_torch.models) held against
the live JAX package's.

For every smoke config of `ARCH_IDS` the JAX package draws its parameters
(`init_params(PRNGKey(0), float32)`), and `convert.params_from_reference`
carries them into the port's `Transformer`. On the same tokens (and frames
and M-RoPE positions where the family takes them), made from a seed with
numpy:

- `prefill_step`'s logits and every tensor of its cache equal the
  reference's at rtol 1e-4 and atol 1e-5 (RTOL, ATOL), but for the
  attention caches, which both packages store in bfloat16. bfloat16
  resolves 2**-8 of a value, so where the two packages' float32 keys or
  values differ in their last bits one may round to the neighbouring
  bfloat16: a bfloat16 tensor must equal the reference's to within one
  bfloat16 step of each element (BF16_STEPS) plus ATOL (values near zero
  carry the float32 sums' absolute rounding);
- a run of `decode_step`s from the reference's prefill cache, held in
  float32 (a decode step writes in its cache's dtype, in both packages),
  gives the reference's logits and caches at RTOL and ATOL at every step.
  In bfloat16 caches the same rounding of each step's new key and value
  moves the logits by up to about 1e-4, so that run is made in float32;
  the bfloat16 path is held end to end by the LMServer's greedy tokens
  (tests/test_torch_lm_serving.py);
- decode after a half-length prefill reproduces the full prefill's logits
  at the reference's own tolerance, 2e-2 (tests/test_arch_smoke.py:57),
  and at F32_CACHE_TOL (1e-4) with its caches in float32;
- a MoE layer whose `capacity_factor` is small enough to drop tokens
  equals the reference's, which checks the stable group-by-expert order
  and the lower-index tie order of top-k;
- the full configs' `param_count()` and `all_cells()` equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
import repro_torch.configs as pc
import repro_torch.models as pmod
from repro.models import moe as rmoe
from repro_torch.convert import params_from_reference
from repro_torch.models import moe as pmoe
from repro_torch.models.transformer import stage_len
from repro_torch.serving.engine import decode_vs_prefill

RTOL, ATOL = 1e-4, 1e-5
BF16_STEPS = 1
F32_CACHE_TOL = 1e-4
B, S = 2, 32
DECODE_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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


def _inputs(cfg, s=S):
    """(reference batch, port batch) of the same arrays."""
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, s)).astype(np.int32)
    arrays = {"tokens": toks}
    if cfg.frontend == "audio_stub":
        arrays["frames"] = rng.normal(0, 0.1, (B, cfg.num_frames,
                                               cfg.d_model)).astype(
                                                   np.float32)
    if cfg.rope_variant == "mrope":
        arrays["mrope_positions"] = np.broadcast_to(
            np.arange(s)[None, None], (3, B, s)).astype(np.int32)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.as_tensor(np.array(v)) for k, v in arrays.items()}
    port["tokens"] = port["tokens"].long()
    if "mrope_positions" in port:
        port["mrope_positions"] = port["mrope_positions"].long()
    return ref, port


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _assert_close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _assert_bf16_close(got, want, what):
    """Equal to within BF16_STEPS bfloat16 steps (2**(e - 7) at exponent e)
    of each of the reference's elements, plus ATOL."""
    g, w = _np(got), _np(want)
    mag = np.abs(w)
    step = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 2.0 ** -133)
    bad = np.abs(g - w) > BF16_STEPS * step + ATOL
    assert not bad.any(), (what, int(bad.sum()), g[bad][:4], w[bad][:4])


def _assert_same_cache(cfg, port_cache, ref_cache):
    """The port's per-layer cache against the reference's stacked one:
    layer i is stage i // stage_len, position i % stage_len."""
    sl = stage_len(cfg)
    assert len(port_cache) == len(jax.tree.leaves(ref_cache["pos0"])[0]) * sl
    for i, c in enumerate(port_cache):
        want = ref_cache[f"pos{i % sl}"]
        assert set(c) == set(want), (i, set(c), set(want))
        for kind in c:
            assert set(c[kind]) == set(want[kind])
            for name, t in c[kind].items():
                w = want[kind][name][i // sl]
                assert tuple(t.shape) == tuple(w.shape), (i, kind, name)
                assert str(t.dtype).split(".")[-1] == str(w.dtype), \
                    (i, kind, name, t.dtype, w.dtype)
                check = (_assert_bf16_close if t.dtype == torch.bfloat16
                         else _assert_close)
                check(t, w, f"layer {i} {kind}.{name}")


# the reference's decode step, compiled once per config (as its LMServer
# runs it)
_ref_decode = jax.jit(lambda p, cfg, t, c, i, mp: rmod.decode_step(
    p, cfg, t, c, i, mrope_positions=mp), static_argnums=1)


def _port_cache(cfg, ref_cache):
    """The reference's stacked cache as the port's per-layer list."""
    sl = stage_len(cfg)
    n = len(pmod.init_cache(cfg, 1, 1, device="cpu"))

    def leaf(a, i):
        a = np.asarray(a[i // sl])
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        return torch.tensor(a)
    return [jax.tree.map(lambda a, i=i: leaf(a, i), ref_cache[f"pos{i % sl}"])
            for i in range(n)]


def _grow(cache, big):
    """The reference's cache written into the prefix of a longer one (as
    tests/test_arch_smoke.py grows it)."""
    return jax.tree.map(
        lambda d, c: (c if d.shape == c.shape
                      else d.at[tuple(slice(0, m) for m in c.shape)].set(
                          c.astype(d.dtype))), big, cache)


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_prefill_and_decode_equal_the_reference(arch, models):
    cfg, rparams, tparams = models(arch)
    rb, pb = _inputs(cfg)
    rl, rcache = rmod.prefill_step(rparams, cfg, rb)
    pl, pcache = pmod.prefill_step(tparams, cfg, pb)
    assert pl.shape == (B, cfg.padded_vocab)
    _assert_close(pl, rl, "prefill logits")
    _assert_same_cache(cfg, pcache, rcache)

    # a run of decode steps after a prefill of the first half, from the
    # reference's cache grown to S in float32
    half = S // 2
    rb0, _ = _inputs(cfg, half)
    _, rcache = rmod.prefill_step(rparams, cfg, rb0)
    rcache = _grow(rcache, rmod.init_cache(cfg, B, S, dtype=jnp.float32))
    pcache = _port_cache(cfg, rcache)
    rmp = (jnp.zeros((3, B, 1), jnp.int32)
           if cfg.rope_variant == "mrope" else None)
    pmp = (torch.zeros((3, B, 1), dtype=torch.long)
           if cfg.rope_variant == "mrope" else None)
    for i in range(half, half + DECODE_STEPS):
        rl, rcache = _ref_decode(rparams, cfg, rb["tokens"][:, i:i + 1],
                                 rcache, jnp.int32(i), rmp)
        pl, pcache = pmod.decode_step(tparams, cfg, pb["tokens"][:, i:i + 1],
                                      pcache, i, mrope_positions=pmp)
        _assert_close(pl, rl, f"decode logits at {i}")
    _assert_same_cache(cfg, pcache, rcache)


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_decode_matches_prefill(arch, models):
    """The port's twin of tests/test_arch_smoke.py::test_decode_matches_
    prefill: decoding the second half after a half-length prefill gives
    the full prefill's logits, in the reference's bfloat16 caches and at
    its tolerance."""
    cfg, _, tparams = models(arch)
    _, pb = _inputs(cfg)
    lg, full = decode_vs_prefill(tparams, cfg, pb["tokens"].numpy(),
                                 pb.get("frames"))
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_decode_matches_prefill_in_float32_caches(arch, models):
    """The same check with the caches in float32: then decode and
    prefill differ only in their sums' order, and agree at F32_CACHE_TOL
    (about 2e-6 is read on the CPU), where a fault of the decode path that
    bfloat16 caches' rounding would hide shows."""
    cfg, _, tparams = models(arch)
    _, pb = _inputs(cfg)
    lg, full = decode_vs_prefill(tparams, cfg, pb["tokens"].numpy(),
                                 pb.get("frames"),
                                 cache_dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=F32_CACHE_TOL,
                               atol=F32_CACHE_TOL)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_moe_drops_the_reference_tokens(arch, models):
    """A capacity factor of 0.25 overflows the experts: which tokens are
    dropped depends on the stable group order and the top-k tie order."""
    cfg, rparams, tparams = models(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.25))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    rp = rparams["stages"]["pos0"]["moe"]
    rp0 = jax.tree.map(lambda a: a[0], rp)
    tp = tparams.blocks[0]["moe"]
    want, want_aux = rmoe.apply_moe(rp0, jnp.asarray(x), cfg)
    with torch.no_grad():
        got, got_aux = pmoe.apply_moe(tp, torch.as_tensor(x), cfg)
    _assert_close(got, want, "moe output")
    _assert_close(got_aux, want_aux, "moe aux loss")
    # tokens were dropped: the capacity holds fewer slots than assignments
    t = x.shape[0] * x.shape[1]
    cap = rmoe._capacity(t, cfg.moe)
    assert pmoe._capacity(t, cfg.moe) == cap
    assert cap * cfg.moe.padded_experts < t * cfg.moe.top_k
    # and the routing itself: gates and expert ids, ties included
    x2 = torch.as_tensor(x.reshape(t, -1))
    with torch.no_grad():
        g, idx, _ = pmoe.router_topk(tp, x2, cfg.moe)
    rg, ridx, _ = rmoe.router_topk(rp0, jnp.asarray(x.reshape(t, -1)),
                                   cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _assert_close(g, rg, "gates")
    # a tie: equal router columns give equal probabilities, and both
    # packages take the lower expert first
    tied = dict(rp0)
    tied["router"] = jnp.asarray(np.repeat(
        np.asarray(rp0["router"])[:, :1], cfg.moe.padded_experts, axis=1))
    _, ridx, _ = rmoe.router_topk(tied, jnp.asarray(x.reshape(t, -1)),
                                  cfg.moe)
    with torch.no_grad():
        _, idx, _ = pmoe.router_topk(
            {"router": torch.tensor(np.asarray(tied["router"]))}, x2,
            cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert (idx.numpy() == np.arange(cfg.moe.top_k)).all()


class _ShapeOnlyMesh:
    def __init__(self, shape):
        self.shape = shape


def test_moe_refuses_a_parallel_context(models):
    """Expert parallelism runs on the ranks of a DeviceMesh: a context on a
    shape-only mesh with a `model` axis is refused; one without a `model`
    axis takes the single-device path (the expert-parallel branch is held
    in tests/test_torch_parallel_moe.py)."""
    from repro_torch.parallel import ParallelContext
    cfg, _, tparams = models("qwen2-moe-a2.7b")
    p = tparams.blocks[0]["moe"]
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, 4, cfg.d_model)).astype(np.float32))
    with pytest.raises(ValueError, match="DeviceMesh"):
        pmoe.apply_moe(p, x, cfg, parallel=ParallelContext(
            _ShapeOnlyMesh({"data": 1, "model": 2})))
    y, aux = pmoe.apply_moe(p, x, cfg, parallel=ParallelContext(
        _ShapeOnlyMesh({"data": 1, "model": 1})))
    y0, aux0 = pmoe.apply_moe(p, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    want, got = rc.get_config(arch), pc.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.padded_vocab == want.padded_vocab
    assert dataclasses.asdict(pc.get_smoke_config(arch)) == \
        dataclasses.asdict(rc.get_smoke_config(arch))
    assert pc.applicable_shapes(got) == rc.applicable_shapes(want)
    assert type(got).__module__ == "repro_torch.configs.base"


def test_all_cells_equal_the_reference():
    assert list(pc.all_cells()) == list(rc.all_cells())
    assert pc.SHAPES == {k: pc.ShapeConfig(**dataclasses.asdict(v))
                         for k, v in rc.SHAPES.items()}
