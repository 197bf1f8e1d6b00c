"""Collectives over one process group, for tensors on the card or the CPU.

The mesh code (expert-parallel MoE, `gpipe`, `compressed_psum`) calls these
instead of `torch.distributed` directly, because the one card of a
single-H100 machine cannot host two NCCL ranks: ranks that share it run
over gloo, and gloo moves CUDA tensors only in `broadcast` and
`all_reduce`. So each collective picks its transport from the group's
backend and the tensor's device (`transport`):

  "nccl"       the tensor goes to NCCL as it is;
  "gloo"       a CPU tensor goes to gloo as it is;
  "gloo-host"  a CUDA tensor under gloo is copied to host memory, moved
               there, and copied back to its device. The copies are
               explicit, in every collective here, so that the transport
               is the same whatever gloo would accept;
  "fake"       the dry run's fake ranks (`launch.mesh.init_fake_ranks`):
               the tensor goes as it is and nothing moves.

Each function is functional: it returns a new tensor and leaves its input
as it was. float8 tensors move as their uint8 bits (gloo has no float8).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def transport(group, device) -> str:
    """"nccl", "gloo" or "gloo-host": how a tensor on `device` moves in
    `group` (None: the default group)."""
    backend = dist.get_backend(group)
    if backend in ("nccl", "fake"):
        return str(backend)
    if torch.device(device).type == "cuda":
        return "gloo-host"
    return str(backend)


def _wire(t: torch.Tensor, group):
    """(the tensor handed to the backend, whether it is a host copy)."""
    t = t.contiguous()
    if t.dtype in _FLOAT8:
        t = t.view(torch.uint8)
    if transport(group, t.device) == "gloo-host":
        return t.cpu(), True
    return t, False


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"):
    """The elementwise `op` ("sum" or "max") of `t` over `group`."""
    if t.dtype in _FLOAT8:
        raise TypeError("all_reduce of float8 bits would add the bits")
    buf, staged = _wire(t, group)
    if not staged:                  # the backend reduces in place
        buf = buf.clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, group=None, dim: int = 0):
    """The members' `t`, concatenated along `dim` in group-rank order (a
    tiled all-gather). Under autograd its gradient is the reduce-scatter
    of the result's gradient: each member's block of the sum."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllGather.apply(t, group, dim)
    return _all_gather(t, group, dim)


def _all_gather(t, group, dim):
    buf, staged = _wire(t, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    if t.dtype in _FLOAT8:
        out = out.view(t.dtype)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0):
    """This member's block, along `dim` in group-rank order, of the sum of
    the members' `t`."""
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":       # gloo has no reduce-scatter
        me = dist.get_group_rank(group, dist.get_rank()) \
            if group is not None else dist.get_rank()
        return all_reduce(t, group).chunk(n, dim)[me].contiguous()
    buf, staged = _wire(t.movedim(dim, 0), group)
    out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(out, buf, group=group)
    out = out.movedim(0, dim)
    return out.to(t.device) if staged else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def ring_shift(t: torch.Tensor, group=None):
    """Sends `t` to the next member of `group` (by group rank, wrapping)
    and returns what the previous member sent: the `ppermute` of
    i -> i + 1."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    me = dist.get_group_rank(group, dist.get_rank()) if group is not None \
        else dist.get_rank()
    nxt, prv = ((me + 1) % n, (me - 1) % n)
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    send, staged = _wire(t, group)
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group=group),
            dist.P2POp(dist.irecv, recv, prv, group=group)]):
        req.wait()
    if t.dtype in _FLOAT8:
        recv = recv.view(t.dtype)
    return recv.to(t.device) if staged else recv
