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

from repro_torch.models.transformer import (Transformer, forward, init_cache,
                                            init_params)


def loss_fn(params, cfg, batch, parallel=None, remat_policy="none"):
    """Next-token cross-entropy + MoE aux loss. batch: dict(tokens (B,S)).
    Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    out = forward(params, cfg, tokens, mode="train",
                  frames=batch.get("frames"),
                  mrope_positions=batch.get("mrope_positions"),
                  parallel=parallel, remat_policy=remat_policy)
    logits = out["logits"].float()[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (logz - gold).mean()
    aux = 0.01 * out["aux_loss"]
    return ce + aux, {"ce": ce, "aux": out["aux_loss"]}


@torch.no_grad()
def prefill_step(params, cfg, batch, parallel=None,
                 cache_dtype=torch.bfloat16):
    """batch: dict(tokens (B,S) integer tensor, optional frames and
    mrope_positions). Returns (next-token logits (B,V), cache), the
    attention caches in `cache_dtype` (the reference's bf16 by default)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
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
