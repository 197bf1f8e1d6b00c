"""Expert-parallel Mixture-of-Experts, the port of src/repro/models/moe.py.

Design (the reference's):
  - experts sharded over the `model` mesh axis (EP); expert d_ff additionally
    sharded over `data` (FSDP) and, for the 1T-class config, expert d_model
    over `pod`. Weights are all-gathered per layer (classic FSDP);
  - tokens stay sharded over the data axes and are *replicated* along
    `model`, so dispatch needs no all-to-all: each rank scatters its local
    tokens into buffers for its local experts, runs the expert FFNs,
    scatters back, and one all-reduce over `model` combines the partial
    outputs;
  - sort-based static-capacity dispatch (MaxText-style): no (T, E, C)
    one-hot dispatch tensor is ever materialized;
  - experts padded to a multiple of the EP degree (qwen2-moe: 60 -> 64),
    padded experts masked to -1e30 in the router.

`apply_moe` runs the local path on one device, or under a context whose
mesh has no `model` axis. With one, it is the reference's `shard_map` body
run by every rank of a `DeviceMesh`: each rank takes its block of the
tokens and of the experts by the specs (DTensors placed so, or tensors
every rank holds whole), routes its local tokens, gathers its experts'
d_ff / d_model shards (in fp8 under `gather_quant`, moved as uint8 bits),
and sums the output over `model` (`parallel.comm`). The capacity is the
data shard's, `_capacity(t_loc, m)`, as in the reference: with data > 1
the result is the local path applied to each data shard, not to the whole
batch.

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
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import _normal, apply_mlp, init_mlp
from repro_torch.parallel import comm
from repro_torch.parallel.api import (P, from_local, local_tensor,
                                      sum_grad_over)


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


def _dispatch_local(x2, top_idx, gates, wi, wg, wo, *, e_off, e_loc, cap,
                    psum_axes=(), mesh=None):
    """Per-rank expert compute. x2 (T, D); top_idx/gates (T, K);
    wi/wg (e_loc, D, F), wo (e_loc, F, D), already gathered to full D/F.
    The output is summed over each of `psum_axes` of `mesh`."""
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
    y = y[:-1]
    for ax in psum_axes:
        y = comm.all_reduce(y, mesh.get_group(ax))
    return y


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
    """x (B, S, D) -> (out (B,S,D), aux_loss).

    parallel: a `repro_torch.parallel.ParallelContext` or None. Without a
    `model` axis this is the single-device path; with one, every rank of
    the context's `DeviceMesh` calls it and gets DTensors: `out` placed as
    the tokens (batch over the data axes), `aux` replicated.
    """
    m = cfg.moe
    b, s, d = x.shape
    if parallel is not None and parallel.has_axis("model"):
        return _apply_moe_ep(p, x, cfg, parallel)
    x2 = x.reshape(b * s, d)
    gates, idx, aux = router_topk(p, x2, m)
    gates = gates.to(x.dtype)
    y = _dispatch_local(x2, idx, gates, p["wi"], p["wg"], p["wo"],
                        e_off=0, e_loc=m.padded_experts,
                        cap=_capacity(b * s, m))
    if m.num_shared_experts:
        y = y + apply_mlp(p["shared"], x2, cfg.act)
    return y.reshape(b, s, d), aux


def _apply_moe_ep(p, x, cfg, parallel):
    """The expert-parallel branch: the reference's shard_map body on this
    rank."""
    mesh = parallel.mesh
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            "expert parallelism runs on the ranks of a DeviceMesh; this "
            f"context's mesh is {type(mesh).__name__}, a shape only")
    m = cfg.moe
    b, s, d = x.shape
    ep = parallel.axis_size("model")
    if m.padded_experts % ep:
        raise ValueError(f"{m.padded_experts} experts do not split over a "
                         f"model axis of {ep}: pad them (MoEConfig."
                         f"ep_pad_to), as the reference's shard_map needs")
    e_loc = m.padded_experts // ep
    dp_axes = parallel.batch_axes(b)       # axes the batch is sharded over
    if "model" in dp_axes:
        raise ValueError(f"the tokens must be replicated over `model`; the "
                         f"{parallel.profile!r} profile shards a batch of "
                         f"{b} over {dp_axes}")
    t_loc = (b * s) // parallel.axes_size(dp_axes)
    cap = _capacity(t_loc, m)
    waxes = parallel.moe_weight_axes(cfg)  # d_model/d_ff -> axis or None
    tok_spec = P(dp_axes if dp_axes else None, None, None)
    wi_spec = P("model", waxes["d_model"], waxes["d_ff"])
    wo_spec = P("model", waxes["d_ff"], waxes["d_model"])

    def gather(w, ax_name, dim):
        """FSDP weight gather, in fp8 under gather_quant (it halves the
        wire bytes of the dominant kimi-1T collective)."""
        g = mesh.get_group(ax_name)
        if parallel.gather_quant:
            return comm.all_gather(w.to(torch.float8_e4m3fn), g, dim
                                   ).to(w.dtype)
        return comm.all_gather(w, g, dim)

    def block(t, spec):
        """This rank's block of `t` under `spec`, a DTensor laid out so
        first (the tokens gathered over `model`, the shared experts
        whole), as the reference's shard_map in_specs lay out its inputs.
        Where `t` is whole on a batch axis, each rank's gradient is its
        tokens' part: it is summed over that axis (the transpose of the
        reference's shard_map sums an input's cotangents so)."""
        if isinstance(t, DTensor):
            t = parallel.constrain(t, *spec)
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        return sum_grad_over(local_tensor(t, mesh, spec), mesh,
                             [mesh.mesh_dim_names.index(a) for a in dp_axes
                              if a not in used])

    x_l = block(x, tok_spec)
    x2_l = x_l.reshape(-1, d)
    wi_l = block(p["wi"], wi_spec)
    wg_l = block(p["wg"], wi_spec)
    wo_l = block(p["wo"], wo_spec)
    # router + top_k on LOCAL tokens (hoisting it out of the body would
    # gather the (tokens, E) probs)
    router = block(p["router"], P(None, None))
    gates_l, idx_l, aux_l = router_topk({"router": router}, x2_l, m)
    gates_l = gates_l.to(x2_l.dtype)
    for ax in dp_axes:                     # pmean over the data axes
        aux_l = comm.all_reduce(aux_l, mesh.get_group(ax))
    aux_l = aux_l / parallel.axes_size(dp_axes)
    e_off = mesh.get_local_rank("model") * e_loc
    # FSDP gather of this layer's expert weights
    if waxes["d_ff"] is not None:
        wi_l = gather(wi_l, waxes["d_ff"], 2)
        wg_l = gather(wg_l, waxes["d_ff"], 2)
        wo_l = gather(wo_l, waxes["d_ff"], 1)
    if waxes["d_model"] is not None:
        wi_l = gather(wi_l, waxes["d_model"], 1)
        wg_l = gather(wg_l, waxes["d_model"], 1)
        wo_l = gather(wo_l, waxes["d_model"], 2)
    # each `model` rank dispatches to its own experts: the gradients of
    # the tokens and the gates it dispatches are its experts' part, summed
    # over `model` (the router, the aux loss and the shared experts run
    # alike on every `model` rank)
    on_model = [mesh.mesh_dim_names.index("model")]
    y = _dispatch_local(sum_grad_over(x2_l, mesh, on_model), idx_l,
                        sum_grad_over(gates_l, mesh, on_model), wi_l, wg_l,
                        wo_l, e_off=e_off, e_loc=e_loc, cap=cap,
                        psum_axes=("model",), mesh=mesh)
    if m.num_shared_experts and not isinstance(x, DTensor):
        names = ("wi", "wg", "wo") if cfg.act == "swiglu" else ("wi", "wo")
        shared = {k: block(p["shared"][k], P(None, None)) for k in names}
        y = y + apply_mlp(shared, x2_l, cfg.act)
    out = from_local(y.reshape(x_l.shape), mesh, tok_spec, x.shape)
    if m.num_shared_experts and isinstance(x, DTensor):
        # as the reference, outside the expert-parallel body: the shared
        # experts' weights stay laid out by the sharding rules
        out = out + apply_mlp(p["shared"], x, cfg.act)
    return out, from_local(aux_l, mesh, P(), ())
