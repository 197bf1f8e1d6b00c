"""The transformer stack covering all assigned families, as an `nn.Module`.

The port of src/repro/models/transformer.py. The reference stacks each
stage position's parameters over stages and `lax.scan`s over them; the
port keeps one parameter tree per layer (`Transformer.blocks`, a
ModuleList) and loops over the layers. Layer i plays the reference's stage
position i % stage_len(cfg), so the mixer and FFN of every layer are the
reference's. The decode cache is a list with one dict per layer, each
holding the reference's per-layer shapes: attention KV (B, Smax, KV, D) in
bf16, whisper's cross-attention KV, RWKV6 and Mamba states.

Modes:
  train   — full-seq causal, returns logits (+ MoE aux loss)
  prefill — full-seq causal, also returns populated KV caches / SSM states
  decode  — single token against caches at position `cur_index`

`init_params` draws from an explicit `torch.Generator` with the
reference's distributions (not its `jax.random` stream);
`repro_torch.convert.params_from_reference` carries the reference's
parameters across instead. `reference_tree` reads a `Transformer` in the
reference's stacked layout, which the optimizer, the checkpoints and the
sharding rules walk; `reference_cache` reads the decode cache so.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

# ---------------------------------------------------------------------------
# structure


def stage_len(cfg) -> int:
    sl = cfg.attn_period
    if cfg.moe is not None:
        sl = math.lcm(sl, cfg.moe.period)
    return sl


def num_stages(cfg) -> int:
    sl = stage_len(cfg)
    assert cfg.num_layers % sl == 0 or sl == 1, (cfg.num_layers, sl)
    return math.ceil(cfg.num_layers / sl)


def num_blocks(cfg) -> int:
    """Layers the stack runs: every position of every stage."""
    return num_stages(cfg) * stage_len(cfg)


def mixer_kind(cfg, j: int) -> str:
    if cfg.family == "ssm":
        return cfg.ssm.variant
    if cfg.is_attn_layer(j):
        return "attn"
    return cfg.ssm.variant  # hybrid non-attn layers


def ffn_kind(cfg, j: int) -> str:
    if cfg.family == "ssm" and cfg.ssm.variant == "rwkv6":
        return "rwkv_cm"  # channel-mix lives inside the rwkv params
    return "moe" if cfg.is_moe_layer(j) else "mlp"


# ---------------------------------------------------------------------------
# parameters


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict values become child
    ParamTrees, lists ModuleLists of them, tensors parameters; `p["wq"]`
    reads it as it reads the dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key):
        return getattr(self, key)


class Transformer(ParamTree):
    """The whole model: `embed`, `blocks` (one per layer), `final_norm`,
    `lm_head`, and for encoder-decoder configs `encoder` and `enc_norm`.
    `forward(tokens, ...)` is the module-level `forward` on these
    parameters."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def forward(self, tokens, **kw):
        return forward(self, self.cfg, tokens, **kw)


class StackedLeaf:
    """One leaf of the reference's parameter tree and the port's parameters
    that make it: block tensors stacked over stages (or encoder layers)
    along a new leading axis, or (`stacked` False) one tensor as it is."""

    def __init__(self, params: List[nn.Parameter], stacked: bool):
        self.params, self.stacked = params, stacked

    @property
    def shape(self) -> tuple:
        p = self.params[0]
        return ((len(self.params),) if self.stacked else ()) + tuple(p.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.params[0].dtype

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def stack(self, tensors) -> torch.Tensor:
        """`tensors`, one per parameter of this leaf, in the leaf's shape."""
        tensors = list(tensors)
        return torch.stack(tensors) if self.stacked else tensors[0]

    def value(self) -> torch.Tensor:
        return self.stack(p.detach() for p in self.params)

    @torch.no_grad()
    def assign(self, value: torch.Tensor) -> None:
        """Copy `value`, of the leaf's shape, into its parameters (a
        DTensor laid out first as its stacked parameters are: never split
        over the stage dim)."""
        if self.stacked and isinstance(value, DTensor):
            value = value.redistribute(value.device_mesh, [
                Shard(q.dim + 1) if isinstance(q, Shard) else q
                for q in self.params[0].placements])
        for p, v in zip(self.params,
                        value.unbind(0) if self.stacked else (value,)):
            p.copy_(v)


def reference_tree(model: ParamTree) -> Dict[str, Any]:
    """`model`'s parameters in the reference's tree: nested dicts keyed as
    `repro.models.init_params` keys them, "stages" / "pos{j}" holding layer
    s * stage_len + j at stage s, and "encoder" the encoder layers, each
    leaf a `StackedLeaf`."""
    sl = stage_len(model.cfg)
    leaves: Dict[tuple, list] = {}
    stacked = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            path = ("stages", f"pos{int(parts[1]) % sl}", *parts[2:])
        elif parts[0] == "encoder":
            path = ("encoder", *parts[2:])
        else:
            path = tuple(parts)
        if path != tuple(parts):
            stacked.add(path)
        leaves.setdefault(path, []).append(p)  # blocks come in stage order
    tree: Dict[str, Any] = {}
    for path, params in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = StackedLeaf(params, path in stacked)
    return tree


def reference_cache(cfg, cache: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The port's decode cache (one dict per layer) in the reference's tree:
    "pos{j}" holding layer s * stage_len + j's state at stage s, each leaf
    a `StackedLeaf` over stages."""
    sl = stage_len(cfg)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([c[k] for c in layers]) for k in layers[0]}
        return StackedLeaf(layers, True)

    return {f"pos{j}": stack(cache[j::sl]) for j in range(sl)}


def _init_block(gen, cfg, j, dtype):
    dev = gen.device
    p: Dict[str, Any] = {"ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, dev)}
    mk = mixer_kind(cfg, j)
    if mk == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype)
        if cfg.cross_attention:
            p["ln_x"] = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
            p["xattn"] = L.init_attention(gen, cfg, dtype)
    elif mk == "rwkv6":
        p["rwkv"] = SSM.init_rwkv6(gen, cfg, dtype)
    elif mk == "mamba":
        p["mamba"] = SSM.init_mamba(gen, cfg, dtype)
    p["ln2"] = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
    fk = ffn_kind(cfg, j)
    if fk == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, dtype)
    elif fk == "mlp":
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _init_enc_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def init_params(cfg, gen: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device=None) -> Transformer:
    """A `Transformer` with random parameters drawn from `gen`, in `dtype`
    (default: the config's `param_dtype`), on `device` (default: the card).
    `gen` must live on that device: the parameters are drawn where they
    stay."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)
    if gen.device.type != dev.type or (
            dev.index is not None and gen.device.index != dev.index):
        raise ValueError(
            f"init_params: the generator is on {gen.device} and the "
            f"parameters are asked for on {dev}; pass a generator made "
            f"with torch.Generator(device={str(dev)!r})")
    sl = stage_len(cfg)
    tree: Dict[str, Any] = {
        "embed": L.init_embed(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "blocks": [_init_block(gen, cfg, i % sl, dtype)
                   for i in range(num_blocks(cfg))],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "lm_head": L._dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }
    if cfg.encoder_layers:
        tree["encoder"] = [_init_enc_layer(gen, cfg, dtype)
                           for _ in range(cfg.encoder_layers)]
        tree["enc_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16,
               device=None) -> List[Dict[str, Any]]:
    """Decode state, one dict per layer."""
    dev = resolve_device(device)
    sl = stage_len(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = []
    for i in range(num_blocks(cfg)):
        mk = mixer_kind(cfg, i % sl)
        c: Dict[str, Any] = {}
        if mk == "attn":
            kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            c["kv"] = {"k": zeros(*kv), "v": zeros(*kv)}
            if cfg.cross_attention:
                xkv = (batch, cfg.num_frames, cfg.num_kv_heads, cfg.head_dim)
                c["xkv"] = {"k": zeros(*xkv), "v": zeros(*xkv)}
        elif mk == "rwkv6":
            c["rwkv"] = SSM.rwkv6_state_init(cfg, batch, dev)
        elif mk == "mamba":
            c["mamba"] = SSM.mamba_state_init(cfg, batch, dev)
        cache.append(c)
    return cache


# ---------------------------------------------------------------------------
# blocks


def _apply_block(bp, x, cfg, j, *, mode, positions, cache, cur_index,
                 parallel, enc_out=None):
    """One layer. Returns (x, new_cache_j, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mk = mixer_kind(cfg, j)
    new_cache = dict(cache) if cache is not None else None

    h = L.apply_norm(bp["ln1"], x, cfg.norm)
    if mk == "attn":
        kv_cache = (cache.get("kv") if (cache is not None
                                        and mode == "decode") else None)
        out, extra = L.attention_apply(
            bp["attn"], h, cfg, positions=positions,
            cache=kv_cache, cache_index=cur_index)
        if mode == "decode":
            new_cache["kv"] = extra
        elif mode == "prefill" and cache is not None and "kv" in cache:
            new_cache["kv"] = {
                "k": L.write_cache(cache["kv"]["k"], extra["k"], 0),
                "v": L.write_cache(cache["kv"]["v"], extra["v"], 0)}
        x = x + out
        if cfg.cross_attention:
            h2 = L.apply_norm(bp["ln_x"], x, cfg.norm)
            if mode == "decode":
                xkv = (cache["xkv"]["k"], cache["xkv"]["v"])
                out2, _ = L.attention_apply(
                    bp["xattn"], h2, cfg, positions=positions,
                    cache=cache["xkv"], kv_override=xkv,
                    cache_index=cur_index)
            else:
                k = L._split_heads(L.mm(enc_out, bp["xattn"]["wk"]),
                                   cfg.num_kv_heads, cfg.head_dim)
                v = L._split_heads(L.mm(enc_out, bp["xattn"]["wv"]),
                                   cfg.num_kv_heads, cfg.head_dim)
                out2, _ = L.attention_apply(
                    bp["xattn"], h2, cfg, positions=positions,
                    kv_override=(k, v), causal=False)
                if cache is not None:  # prefill fills the cross cache
                    new_cache["xkv"] = {
                        "k": k.to(cache["xkv"]["k"].dtype),
                        "v": v.to(cache["xkv"]["v"].dtype)}
            x = x + out2
    elif mk == "rwkv6":
        st = {"shift": cache["rwkv"]["shift_tm"], "wkv": cache["rwkv"]["wkv"]}
        out, nst = SSM.rwkv6_time_mix(bp["rwkv"], h, cfg, st)
        new_cache["rwkv"] = dict(cache["rwkv"])
        new_cache["rwkv"]["shift_tm"] = nst["shift"].to(
            cache["rwkv"]["shift_tm"].dtype)
        new_cache["rwkv"]["wkv"] = nst["wkv"]
        x = x + out
    elif mk == "mamba":
        out, nst = SSM.mamba_mix(bp["mamba"], h, cfg, cache["mamba"])
        new_cache["mamba"] = {
            "conv": nst["conv"].to(cache["mamba"]["conv"].dtype),
            "ssm": nst["ssm"]}
        x = x + out

    fk = ffn_kind(cfg, j)
    h = L.apply_norm(bp["ln2"], x, cfg.norm)
    if fk == "moe":
        out, aux = MOE.apply_moe(bp["moe"], h, cfg, parallel)
    elif fk == "rwkv_cm":
        out, nshift = SSM.rwkv6_channel_mix(bp["rwkv"], h,
                                            cache["rwkv"]["shift_cm"])
        new_cache["rwkv"]["shift_cm"] = nshift.to(
            cache["rwkv"]["shift_cm"].dtype)
    else:
        out = L.apply_mlp(bp["mlp"], h, cfg.act)
    x = x + out
    return x, new_cache, aux


def _encoder(params, cfg, frames):
    """frames: (B, F, D) stub embeddings."""
    nf = frames.shape[1]
    pos = L.sinusoidal_positions(nf, cfg.d_model, frames.device)
    x = frames + pos[None].to(frames.dtype)
    positions = torch.arange(nf, device=frames.device)[None]
    for lp in params["encoder"]:
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        out, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                                   causal=False)
        x = x + out
        h = L.apply_norm(lp["ln2"], x, cfg.norm)
        x = x + L.apply_mlp(lp["mlp"], h, cfg.act)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def _dots_saveable(ctx, op, *args, **kwargs):
    """jax.checkpoint_policies.dots_with_no_batch_dims_saveable in torch:
    keep the weight products (mm and addmm, no batch dimension) and
    recompute everything else, the attention's batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat_policy):
    """checkpoint's context_fn for `remat_policy`: "full" keeps only each
    block's inputs, "dots" the weight products too."""
    if remat_policy == "full":
        return noop_context_fn
    if remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_saveable)
    raise ValueError(f"remat_policy must be 'none', 'full' or 'dots', not "
                     f"{remat_policy!r}")


def forward(params, cfg, tokens, *, mode="train", cache=None, cur_index=None,
            frames=None, mrope_positions=None, parallel=None,
            remat_policy="none"):
    """tokens (B,S) integer tensor on the parameters' device. Returns
    dict(logits, cache, aux_loss). `parallel`, a `ParallelContext` or None,
    lays the activations out tokens-major after the embedding and after
    each block, as the reference does; on a one-device mesh that changes
    nothing. On a larger mesh the parameters, the tokens and the cache are
    DTensors placed by `parallel.sharding`'s rules (the dry run,
    `launch.dryrun`), and `cur_index` is a Python int.
    `remat_policy` "full" or "dots" recomputes each block in the backward
    pass, as the reference's `jax.checkpoint` of its stage function does."""
    b, s = tokens.shape
    dev = tokens.device
    if cur_index is not None:
        cur_index = int(cur_index)
    x = L.embed(params["embed"]["table"], tokens)

    if cfg.rope_variant == "mrope":
        positions = (mrope_positions if mrope_positions is not None
                     else torch.arange(s, device=dev)[None, None].expand(
                         3, b, s))
    else:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    if mode == "decode":
        positions = positions + cur_index
    if cfg.rope_variant == "none" and cfg.family in ("audio",):
        if mode == "decode":
            max_len = cache[0]["kv"]["k"].shape[1]
            table = L.sinusoidal_positions(max_len, cfg.d_model, dev)
            start = max(0, min(cur_index, max_len - 1))
            pos = table[start:start + 1]
        else:
            pos = L.sinusoidal_positions(max(s, 1), cfg.d_model, dev)[:s]
        x = x + pos[None].to(x.dtype)

    enc_out = None
    if cfg.encoder_layers and mode != "decode":
        assert frames is not None, "whisper needs stub frame embeddings"
        enc_out = _encoder(params, cfg, frames)

    if cache is None:
        cache = init_cache(cfg, b, 1 if mode == "train" else s, device=dev)

    if parallel is not None:
        x = parallel.constrain_tokens_major(x, b)

    sl = stage_len(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_cache = []
    remat_ctx = (None if remat_policy == "none"
                 else _remat_context(remat_policy))
    for i, bp in enumerate(params["blocks"]):
        kw = dict(mode=mode, positions=positions, cache=cache[i],
                  cur_index=cur_index, parallel=parallel, enc_out=enc_out)
        if remat_ctx is None:
            x, nc, a = _apply_block(bp, x, cfg, i % sl, **kw)
        else:
            x, nc, a = checkpoint(_apply_block, bp, x, cfg, i % sl,
                                  use_reentrant=False, context_fn=remat_ctx,
                                  **kw)
        if parallel is not None:
            x = parallel.constrain_tokens_major(x, x.shape[0])
        new_cache.append(nc)
        aux = aux + a

    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.mm(x, params["lm_head"])
    return {"logits": logits, "cache": new_cache, "aux_loss": aux}
