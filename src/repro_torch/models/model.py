"""Public model API: the loss, the prefill and decode steps, and the
dry run's abstract inputs and parameters.

The port of src/repro/models/model.py. `loss_fn` runs under autograd;
`prefill_step` and `decode_step` are inference steps and run without it.
`input_specs` and `abstract_params` build shapes and dtypes on the `meta`
device, with no allocation.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.transformer import (Transformer, forward, init_cache,
                                            init_params)
from repro_torch.parallel.api import (block_start, max_over, on_shards,
                                      sum_over)


def loss_fn(params, cfg, batch, parallel=None, remat_policy="none"):
    """Next-token cross-entropy + MoE aux loss. batch: dict(tokens (B,S)).
    Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    out = forward(params, cfg, tokens, mode="train",
                  frames=batch.get("frames"),
                  mrope_positions=batch.get("mrope_positions"),
                  parallel=parallel, remat_policy=remat_policy)
    if isinstance(out["logits"], DTensor):
        ce = _cross_entropy_sharded(out["logits"], tokens)
    else:
        logits = out["logits"].float()[:, :-1]
        targets = tokens[:, 1:].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        ce = (logz - gold).mean()
    aux = 0.01 * out["aux_loss"]
    return ce + aux, {"ce": ce, "aux": out["aux_loss"]}


def _cross_entropy_sharded(logits, tokens):
    """`loss_fn`'s mean next-token cross-entropy of DTensor logits
    (B,S,V), each rank on its tokens and its block of the vocabulary: the
    max, the sum of exponentials and the target's logit are reduced over
    the ranks that hold the other blocks (no rank holds whole logits),
    and the per-token losses summed over every rank."""
    mesh = logits.device_mesh
    b, s, _ = logits.shape
    lpl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, lpl)
    # each position's next token (the last position's is masked out)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    tpl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in lpl]
    vocab = [i for i, p in enumerate(lpl) if p == Shard(2)]
    split = [i for i, p in enumerate(lpl) if p.is_shard()]

    def local(lg, tg):
        lg = lg.float()
        n_v, n_s = lg.shape[-1], lg.shape[1]
        m = max_over(torch.amax(lg, dim=-1), mesh, vocab)
        se = sum_over(torch.sum(torch.exp(lg - m[..., None]), dim=-1),
                      mesh, vocab)
        idx = tg.long() - block_start(mesh, lpl, 2, n_v)
        hit = (idx >= 0) & (idx < n_v)
        gold = torch.gather(lg, -1, idx.clamp(0, n_v - 1)[..., None])[..., 0]
        gold = sum_over(torch.where(hit, gold, 0.0), mesh, vocab)
        pos = block_start(mesh, lpl, 1, n_s) + torch.arange(
            n_s, device=lg.device)
        ce = torch.where(pos < s - 1, torch.log(se) + m - gold, 0.0)
        total = sum_over(ce.sum(), mesh,
                         [i for i in split if i not in vocab])
        return (total / (b * (s - 1)),)

    return on_shards(local, mesh, (logits, targets), (lpl, tpl),
                     ([Replicate()] * mesh.ndim,))[0]


@torch.no_grad()
def prefill_step(params, cfg, batch, parallel=None,
                 cache_dtype=torch.bfloat16, cache=None):
    """batch: dict(tokens (B,S) integer tensor, optional frames and
    mrope_positions). Returns (next-token logits (B,V), cache), the
    attention caches in `cache_dtype` (the reference's bf16 by default).
    `cache`, zeros of the prompt's length, is the cache to fill (the dry
    run's is placed on its mesh); by default the step makes it."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, s, dtype=cache_dtype, device=tokens.device)
    out = forward(params, cfg, tokens, mode="prefill", cache=cache,
                  frames=batch.get("frames"),
                  mrope_positions=batch.get("mrope_positions"),
                  parallel=parallel)
    # next-token logits from the last position
    return out["logits"][:, -1], out["cache"]


@torch.no_grad()
def decode_step(params, cfg, tokens, cache, cur_index, parallel=None,
                mrope_positions=None):
    """tokens (B,1); cur_index an int. Returns (logits, cache)."""
    out = forward(params, cfg, tokens, mode="decode", cache=cache,
                  cur_index=cur_index, parallel=parallel,
                  mrope_positions=mrope_positions)
    return out["logits"][:, -1], out["cache"]


# ---------------------------------------------------------------------------
# dry-run input specs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Meta tensors for every input of (cfg, shape). For decode shapes
    this includes the decode cache, one dict per layer (input AND output of
    the step). Modality frontends are stubs: precomputed frame/patch
    embeddings."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.mode in ("train", "prefill"):
        specs["tokens"] = _meta((b, s), torch.int32)
        if cfg.frontend == "audio_stub":
            specs["frames"] = _meta((b, cfg.num_frames, cfg.d_model),
                                    torch.bfloat16)
        if cfg.rope_variant == "mrope":
            specs["mrope_positions"] = _meta((3, b, s), torch.int32)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["cur_index"] = _meta((), torch.int32)
        specs["cache"] = init_cache(cfg, b, s, device="meta")
        if cfg.rope_variant == "mrope":
            specs["mrope_positions"] = _meta((3, b, 1), torch.int32)
    return specs


def _meta_tree(module: nn.Module) -> Dict[str, Any]:
    tree: Dict[str, Any] = {k: _meta(p.shape, p.dtype) for k, p in
                            module.named_parameters(recurse=False)}
    for k, child in module.named_children():
        tree[k] = ([_meta_tree(c) for c in child]
                   if isinstance(child, nn.ModuleList) else _meta_tree(child))
    return tree


def abstract_params(cfg, dtype=None) -> Transformer:
    """A `Transformer` of meta tensors: the parameters' shapes and dtypes
    without allocation (init_params traced under a FakeTensorMode)."""
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=dtype, device="cpu")
    return Transformer(cfg, _meta_tree(fake))
