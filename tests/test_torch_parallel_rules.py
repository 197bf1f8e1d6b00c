"""The port's sharding rules (repro_torch.parallel) against the live JAX
package's, axis for axis.

For every full config of `ARCH_IDS`, on the shape-only single (16, 16) and
multi-pod (2, 16, 16) meshes, under each profile "2d", "fsdp" and "tp":

- `param_pspecs` on the port's `abstract_params` (read as the reference's
  stacked tree) and `opt_state_pspecs` on the port's optimizer state for
  `optim.for_model(cfg)` equal the reference's specs for every leaf, keyed
  by path, and every named axis divides its dimension (the reference's own
  check, tests/test_sharding.py:35-49);
- `batch_pspecs` of `input_specs` for every shape of `applicable_shapes`,
  the decode caches' `cache_pspecs` included, likewise;

and the twins of tests/test_sharding.py:72-76 (expert padding divides EP)
and :109-116 (kimi's pod FSDP rule), `ParallelContext`'s refusals, and
`PartitionSpec`'s normalisation (jax's). The placements of those specs on
live ranks are held in tests/test_torch_parallel_collectives.py.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

import repro.configs as rc
import repro.models as rmod
from repro.parallel import sharding as rsh
from repro.parallel.api import ParallelContext as RefContext
from repro.training import optim as roptim
from repro_torch.configs import get_config, get_shape
from repro_torch.models import abstract_params, input_specs
from repro_torch.models.transformer import reference_cache
from repro_torch.parallel import P, ParallelContext
from repro_torch.parallel import sharding as sh
from repro_torch.training import optim
from repro_torch.training.tree import param_tree

PROFILES = ("2d", "fsdp", "tp")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Shape-only mesh stand-in (no devices needed for rule validation)."""

    def __init__(self, shape: dict):
        self.shape = shape

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))


def _contexts(mesh, profile):
    return (ParallelContext(FakeMesh(MESHES[mesh]), profile=profile),
            RefContext(FakeMesh(MESHES[mesh]), profile=profile))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(port cfg, port meta model, port meta opt state, reference cfg,
    reference abstract params, reference abstract opt state)."""
    cfg, rcfg = get_config(arch), rc.get_config(arch)
    model = abstract_params(cfg)
    state = optim.init_state(model, optim.for_model(cfg), device="meta")
    rap = rmod.abstract_params(rcfg)
    rstate = jax.eval_shape(
        lambda p: roptim.init_state(p, roptim.for_model(rcfg)), rap)
    return cfg, model, state, rcfg, rap, rstate


def _port_specs(tree, prefix=()):
    """{path: spec} of a port spec tree."""
    if isinstance(tree, P):
        return {"/".join(map(str, prefix)): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_specs(v, prefix + (k,)))
    return out


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): v for kp, v in flat}


def _shapes(tree, prefix=()):
    """{path: shape} of a tree of meta tensors or StackedLeaf-likes."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, prefix)): tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, prefix + (k,)))
    return out


def _assert_equal_and_divisible(ctx, got, want, shapes):
    got = _port_specs(got)
    want = _ref_specs(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), (path, got[path], spec)
    for path, spec in got.items():
        shape = shapes[path]
        assert len(spec) <= len(shape), (path, spec, shape)
        for dim, ax in zip(shape, spec):
            if ax is not None:
                assert dim % ctx.axes_size(
                    (ax,) if isinstance(ax, str) else ax) == 0, (path, spec)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_param_and_opt_state_specs_equal_the_reference(arch, mesh, profile):
    cfg, model, state, rcfg, rap, rstate = _abstract(arch)
    ctx, rctx = _contexts(mesh, profile)
    specs = sh.param_pspecs(ctx, cfg, model)
    rspecs = rsh.param_pspecs(rctx, rcfg, rap)
    shapes = _shapes(param_tree(model))
    _assert_equal_and_divisible(ctx, specs, rspecs, shapes)
    ospecs = sh.opt_state_pspecs(ctx, cfg, state, specs)
    rospecs = rsh.opt_state_pspecs(rctx, rcfg, rstate, rspecs)
    _assert_equal_and_divisible(ctx, ospecs, rospecs, _shapes(state))


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh, profile):
    cfg, rcfg = get_config(arch), rc.get_config(arch)
    ctx, rctx = _contexts(mesh, profile)
    names = rc.applicable_shapes(rcfg)
    assert names
    for name in names:
        specs = input_specs(cfg, get_shape(name))
        got = sh.batch_pspecs(ctx, cfg, specs)
        want = rsh.batch_pspecs(rctx, rcfg,
                                rmod.input_specs(rcfg, rc.get_shape(name)))
        shapes = {k: tuple(v.shape) for k, v in specs.items()
                  if k != "cache"}
        if "cache" in specs:
            shapes.update({f"cache/{k}": v for k, v in _shapes(
                reference_cache(cfg, specs["cache"])).items()})
            assert _port_specs(got["cache"]), name
        _assert_equal_and_divisible(ctx, got, want, shapes)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_moe_expert_padding_divides_ep(arch):
    cfg = get_config(arch)
    assert cfg.moe.padded_experts % 16 == 0
    ctx = ParallelContext(FakeMesh(MESHES["single"]))
    wi = sh.param_pspecs(ctx, cfg, abstract_params(cfg))
    wi = [s for path, s in _port_specs(wi).items()
          if path.endswith("moe/wi")]
    assert wi and all(s[1] == "model" for s in wi)


def test_kimi_pod_fsdp_rule():
    cfg = get_config("kimi-k2-1t-a32b")
    ctx = ParallelContext(FakeMesh(MESHES["multi"]))
    assert ctx.moe_weight_axes(cfg) == {"d_ff": "data", "d_model": "pod"}
    assert ctx.moe_weight_axes(cfg) == RefContext(
        FakeMesh(MESHES["multi"])).moe_weight_axes(
            rc.get_config("kimi-k2-1t-a32b"))
    w2 = ctx.moe_weight_axes(get_config("qwen2-moe-a2.7b"))
    assert w2["d_model"] is None  # only the 1T-class shards over pod


def test_partition_spec_normalises_as_jax():
    for entries in [(("data",), None), ((), "model"), (("pod", "data"),),
                    ("data", ("model",), None), ()]:
        assert tuple(P(*entries)) == tuple(RefP(*entries)), entries
    assert P(("data",), None) == P("data", None) != P("data")


def test_context_refuses_what_it_cannot_lay_out():
    one = ParallelContext(FakeMesh({"data": 1, "model": 1}))
    x = torch.ones(2, 4, 8)
    assert one.size == 1 and one.constrain_tokens_major(x, 2) is x
    big = ParallelContext(FakeMesh({"data": 2, "model": 2}))
    with pytest.raises(TypeError, match="needs a DTensor"):
        big.constrain_tokens_major(x, 2)
    with pytest.raises(ValueError, match="not among"):
        ParallelContext(FakeMesh({"rows": 2}))
    with pytest.raises(ValueError, match="mesh's order"):
        big.sharding(P(("model", "data"))).placements
    with pytest.raises(ValueError, match="twice"):
        big.sharding(P("data", "data")).placements
