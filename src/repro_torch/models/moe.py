"""Mixture-of-Experts, single-device branch.

The port of src/repro/models/moe.py for `parallel is None`: a softmax
router with top-k gates, and sort-based static-capacity dispatch (no
(T, E, C) one-hot tensor), experts padded to `MoEConfig.padded_experts` and
masked to -1e30 in the router. The expert-parallel branch of the reference
(`jax.shard_map` over the `model` mesh axis) comes with the port of
`parallel/` (ROADMAP A11c); until then `apply_moe` refuses a `parallel`
context.

Two orders decide which tokens a full expert drops, and both are the
reference's: tokens are grouped by expert with a STABLE sort (jnp.argsort
is stable), and top-k breaks ties toward the lower expert index, as
`jax.lax.top_k` does (a stable descending sort; `torch.topk` promises no
tie order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, apply_mlp, init_mlp


def init_moe(gen, cfg, dtype):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.padded_experts
    scale = 1.0 / math.sqrt(d)
    p = {
        # router kept f32 (standard practice)
        "router": _normal(gen, (d, e), scale),
        "wi": _normal(gen, (e, d, f), scale).to(dtype),
        "wg": _normal(gen, (e, d, f), scale).to(dtype),
        "wo": _normal(gen, (e, f, d), 1.0 / math.sqrt(f)).to(dtype),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, f * m.num_shared_experts, cfg.act,
                               dtype)
    return p


def _capacity(tokens_local: int, m) -> int:
    c = int(math.ceil(tokens_local * m.top_k * m.capacity_factor
                      / m.padded_experts))
    c = max(8, ((c + 7) // 8) * 8)
    # no point exceeding the worst case (every token to one expert)
    return min(c, ((tokens_local * m.top_k + 7) // 8) * 8)


def _dispatch_local(x2, top_idx, gates, wi, wg, wo, *, e_off, e_loc, cap):
    """Expert compute on one device. x2 (T, D); top_idx/gates (T, K);
    wi/wg (e_loc, D, F), wo (e_loc, F, D)."""
    t, d = x2.shape
    k = top_idx.shape[1]
    dev = x2.device
    flat_e = top_idx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)

    local = (flat_e >= e_off) & (flat_e < e_off + e_loc)
    le = torch.where(local, flat_e - e_off, e_loc)         # e_loc == drop
    order = torch.argsort(le, stable=True)                 # group by expert
    le_s, tok_s, g_s = le[order], flat_t[order], flat_g[order]

    # rank within expert group: position - group start
    starts = torch.searchsorted(le_s, torch.arange(e_loc + 1, device=dev,
                                                   dtype=le_s.dtype))
    pos = torch.arange(t * k, device=dev) - starts[
        torch.clamp(le_s, 0, e_loc)]
    ok = (le_s < e_loc) & (pos < cap)
    slot = torch.where(ok, le_s * cap + pos, e_loc * cap)  # overflow row

    # slots -> token ids / gate weights first, then gather/scatter in
    # compact slot space; the overflow row (index n_slot) is cut off
    n_slot = e_loc * cap
    tok_for_slot = torch.full((n_slot + 1,), t, dtype=torch.int64,
                              device=dev)
    tok_for_slot[slot] = tok_s
    tok_for_slot = tok_for_slot[:-1]
    gate_for_slot = torch.zeros((n_slot + 1,), dtype=x2.dtype, device=dev)
    gate_for_slot[slot] = torch.where(ok, g_s, 0.0).to(x2.dtype)
    gate_for_slot = gate_for_slot[:-1]
    x_pad = torch.cat([x2, torch.zeros((1, d), dtype=x2.dtype, device=dev)])
    h = x_pad[torch.clamp(tok_for_slot, max=t)].reshape(e_loc, cap, d)

    up = torch.einsum("ecd,edf->ecf", h, wi.to(x2.dtype))
    gate = torch.einsum("ecd,edf->ecf", h, wg.to(x2.dtype))
    act = F.silu(gate) * up
    out_e = torch.einsum("ecf,efd->ecd", act, wo.to(x2.dtype))

    flat_out = out_e.reshape(n_slot, d) * gate_for_slot[:, None]
    y = torch.zeros((t + 1, d), dtype=x2.dtype, device=dev)
    y.index_add_(0, tok_for_slot, flat_out)
    return y[:-1]


def router_topk(p, x2, m):
    """Returns (gates (T,K) f32, idx (T,K) int64, aux_loss scalar)."""
    logits = x2.float() @ p["router"]
    if m.padded_experts > m.num_experts:
        pad_mask = torch.arange(m.padded_experts,
                                device=x2.device) >= m.num_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, ties to the lower index
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing loss (bincount, no (T,E,K) one-hot)
    counts = torch.zeros((m.padded_experts,), dtype=torch.float32,
                         device=x2.device)
    counts.index_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=x2.device))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    pbar = probs.mean(0)
    aux = m.num_experts * torch.sum(f * pbar)
    return gates, idx, aux


def apply_moe(p, x, cfg, parallel=None):
    """x (B, S, D) -> (out (B,S,D), aux_loss). Single device only."""
    if parallel is not None:
        raise ValueError(
            "apply_moe runs on one device in this port (parallel=None); "
            "the expert-parallel branch comes with parallel/ (ROADMAP "
            "A11c)")
    m = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, idx, aux = router_topk(p, x2, m)
    gates = gates.to(x.dtype)
    y = _dispatch_local(x2, idx, gates, p["wi"], p["wg"], p["wo"],
                        e_off=0, e_loc=m.padded_experts,
                        cap=_capacity(b * s, m))
    if m.num_shared_experts:
        y = y + apply_mlp(p["shared"], x2, cfg.act)
    return y.reshape(b, s, d), aux
