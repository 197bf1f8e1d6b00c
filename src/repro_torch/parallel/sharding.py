"""Logical-axis sharding rules: param / input / state PartitionSpecs.

The port of src/repro/parallel/sharding.py. The rules run on the
reference's trees, so their paths, their stacked shapes and every spec are
the reference's: a `Transformer` is read through
`models.transformer.reference_tree`, the port's per-layer decode cache
through `reference_cache`. A stacked leaf's `P(None, *body)` places each of
its per-layer tensors with `body`.

Name-based rules (MaxText-style) with divisibility fallbacks: an axis is only
assigned if it divides the dimension; otherwise that dim stays replicated.

Conventions (mesh axes: optional "pod", "data", "model"):
  - 2-D param sharding (FSDP x TP): weights (d_model, d_ff)-like get
    (data, model); their transposes (model, data).
  - embeddings/lm_head: vocab -> model, d_model unsharded (gathers stay local)
  - MoE experts: E -> model (EP); d_ff -> data; d_model -> pod for 1T-class
  - KV caches: kv_heads -> model when divisible, else sequence -> model
    (flash-decoding style); batch -> (pod, data).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.transformer import reference_cache
from repro_torch.parallel.api import P, ParallelContext
from repro_torch.training.tree import param_tree


def _spec(ctx: ParallelContext, shape, axes):
    """Build a PartitionSpec, dropping any axis that doesn't divide."""
    return P(*(ax if ax is not None and ctx.divides(dim, ax) else None
               for dim, ax in zip(shape, axes)))


def _param_rule(ctx: ParallelContext, cfg, path: str, leaf) -> P:
    shape = tuple(leaf.shape)
    stacked = path.startswith("stages/") or path.startswith("encoder/")
    body = shape[1:] if stacked else shape

    def done(axes):
        sp = _spec(ctx, body, tuple(axes))
        return P(None, *sp) if stacked else sp

    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    # "tp" profile (decode): weights sharded over model ONLY — 2D (data x
    # model) sharding makes every decode step all-gather weight shards over
    # `data`
    da = None if ctx.profile == "tp" else "data"

    if ctx.profile == "fsdp" and parent != "moe":
        # ZeRO-3: shard the last dim over every divisible mesh axis,
        # replicate the rest. 1-D params (norm scales, mixing coefficients)
        # are sharded too: replicating them makes their grads full
        # all-reduces
        if len(body) >= 1:
            ax = ctx.fsdp_weight_axes(body[-1])
            return done((None,) * (len(body) - 1) + (ax,))
        return done((None,) * len(body))

    if parent == "moe" and name in ("wi", "wg"):   # (E, D, F) experts
        w = ctx.moe_weight_axes(cfg)
        return done(("model", w["d_model"], w["d_ff"]))
    if parent == "moe" and name == "wo":           # (E, F, D)
        w = ctx.moe_weight_axes(cfg)
        return done(("model", w["d_ff"], w["d_model"]))
    if parent == "moe" and name == "router":
        return done((None, None))

    if name == "table":                      # embedding (V, D)
        return done(("model", None))
    if name == "lm_head":                    # (D, V)
        return done((None, "model"))

    if name in ("wq", "wk", "wv", "wi", "wg", "cm_wk", "cm_wr", "wr",
                "in_proj", "x_proj_in"):
        if len(body) == 2:
            return done((da, "model"))
    if name in ("wo", "cm_wv", "out_proj", "dt_proj"):
        if len(body) == 2:
            return done(("model", da))
    if name == "x_proj":
        return done(("model", None))
    if name == "conv_w":
        return done((None, "model"))
    if name in ("conv_b", "dt_bias", "d_skip"):
        return done(("model",))
    if name == "a_log":
        return done(("model", None))
    if name == "lora_a":
        return done((da, None))
    if name == "lora_b":
        return done((None, da))
    # norms, biases, mixing coefficients, u: replicated
    return done((None,) * len(body))


def _map_with_path(fn, tree, prefix=()):
    """`fn(path, leaf)` over a tree of dicts and lists, keeping its
    structure; a PartitionSpec is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, prefix + (i,))
                for i, v in enumerate(tree)]
    return fn("/".join(map(str, prefix)), tree)


def param_pspecs(ctx: ParallelContext, cfg, abstract_params):
    """Specs of the reference's parameter tree: `abstract_params` is a
    `Transformer` (meta tensors or real ones) or that tree already."""
    return _map_with_path(lambda path, leaf: _param_rule(ctx, cfg, path,
                                                         leaf),
                          param_tree(abstract_params))


def opt_state_pspecs(ctx: ParallelContext, cfg, abstract_state, param_specs):
    """Optimizer state mirrors param sharding; factored stats drop the
    corresponding trailing dim."""
    def per_param(pspec, stats):
        base = list(pspec)
        out = {}
        for k in stats:
            if k in ("m", "v"):
                out[k] = pspec
            elif k == "vr":
                out[k] = P(*base[:-1])
            elif k == "vc":
                out[k] = P(*(base[:-2] + base[-1:]))
        return out

    def walk(specs, stats):
        if isinstance(specs, P):
            return per_param(specs, stats)
        return {k: walk(specs[k], stats[k]) for k in specs}

    return {"mu": walk(param_specs, abstract_state["mu"]), "step": P()}


def batch_pspecs(ctx: ParallelContext, cfg, specs: Dict[str, Any]):
    """Shardings for input_specs() trees (train/prefill/decode)."""
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "tokens":
            out[k] = P(ctx.dp_spec(v.shape[0]), None)
        elif k == "frames":
            out[k] = P(ctx.dp_spec(v.shape[0]), None, None)
        elif k == "mrope_positions":
            out[k] = P(None, ctx.dp_spec(v.shape[1]), None)
        elif k == "cur_index":
            out[k] = P()
        elif k == "cache":
            out[k] = cache_pspecs(ctx, cfg, v)
        else:
            out[k] = P()
    return out


def cache_pspecs(ctx: ParallelContext, cfg, abstract_cache):
    """KV/SSM state shardings of the reference's cache tree, stacked over
    stages (leading dim): `abstract_cache` is the port's per-layer list, as
    `init_cache` makes it. Where the batch is split over `model` too (the
    fsdp profile's batch over (data, model)), no other dim is: the
    reference's rule would name `model` twice, a spec no mesh can place
    (none of its callers places a cache so)."""
    def rule(path, leaf):
        shape = tuple(leaf.shape)  # (ns, B, ...)
        name = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""
        dp = ctx.dp_spec(shape[1])

        def on_model(dim):
            return "model" not in (dp or ()) and ctx.divides(dim, "model")

        if parent in ("kv", "xkv"):            # (ns, B, S, KV, hd)
            kvh, s = shape[3], shape[2]
            if on_model(kvh) and ctx.has_axis("model"):
                return P(None, dp, None, "model", None)
            if on_model(s):
                return P(None, dp, "model", None, None)
            return P(None, dp, None, None, None)
        if name == "wkv":                       # (ns, B, H, K, V)
            if on_model(shape[2]) and ctx.has_axis("model"):
                return P(None, dp, "model", None, None)
            if on_model(shape[4]):
                return P(None, dp, None, None, "model")
            return P(None, dp, None, None, None)
        if name in ("shift_tm", "shift_cm"):    # (ns, B, D)
            return P(None, dp, "model" if on_model(shape[2]) else None)
        if name == "conv":                      # (ns, B, K-1, Di)
            return P(None, dp, None, "model" if on_model(shape[3]) else None)
        if name == "ssm":                       # (ns, B, Di, N)
            return P(None, dp, "model" if on_model(shape[2]) else None, None)
        return P(*([None] * len(shape)))

    return _map_with_path(rule, reference_cache(cfg, abstract_cache))


def logits_pspec(ctx: ParallelContext, batch):
    return P(ctx.dp_spec(batch), "model")
