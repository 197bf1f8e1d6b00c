"""Public model API of this slice: the prefill and decode steps.

The port of src/repro/models/model.py's `prefill_step` and `decode_step`.
Both are inference steps and run without autograd. `loss_fn` comes with
the training slice (ROADMAP A11b); `input_specs` and `abstract_params`,
which serve the multi-pod dry run, with `parallel/` (A11c).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import forward, init_cache


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
