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

`host_stats` counts the "gloo-host" copies of this process (copies, bytes
and the seconds they took, each copy synchronised), the transports its
collectives took, and the moves of DTensors (in `redistribute` and inside
DTensor's ops) that went through them (`api._dtensor_move`); `reset_host_stats` sets it to zero.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)

host_stats: dict = {}


def reset_host_stats() -> None:
    host_stats.update(copies=0, bytes=0, seconds=0.0, transports={},
                      dtensor_moves=0)


reset_host_stats()


def _host_copy(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of `t` on `device` (host memory or the card), timed into
    `host_stats`."""
    t0 = time.perf_counter()
    out = t.to(device, copy=True)
    if out.device.type == "cuda" or t.device.type == "cuda":
        torch.cuda.synchronize(out.device if out.device.type == "cuda"
                               else t.device)
    host_stats["copies"] += 1
    host_stats["bytes"] += t.numel() * t.element_size()
    host_stats["seconds"] += time.perf_counter() - t0
    return out


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
    how = transport(group, t.device)
    seen = host_stats["transports"]
    seen[how] = seen.get(how, 0) + 1
    if how == "gloo-host":
        return _host_copy(t, "cpu"), True
    return t, False


def _back(out: torch.Tensor, like: torch.Tensor, staged: bool):
    """`out`, the backend's result, on `like`'s device and in its dtype
    (float8 bits viewed back)."""
    if like.dtype in _FLOAT8:
        out = out.view(like.dtype)
    return _host_copy(out, like.device) if staged else out


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"):
    """The elementwise `op` ("sum", "max" or "min") of `t` over `group`.
    Under autograd (a sum) its gradient is the result's, which every
    member holds whole: each member's part gets it as it is."""
    if op == "sum" and torch.is_grad_enabled() and t.requires_grad:
        return _AllReduce.apply(t, group)
    return _all_reduce(t, group, op)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce(t: torch.Tensor, group, op: str):
    if t.dtype in _FLOAT8:
        raise TypeError("all_reduce of float8 bits would add the bits")
    buf, staged = _wire(t, group)
    if not staged:                  # the backend reduces in place
        buf = buf.clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return _back(buf, t, staged)


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
    return _back(torch.cat(parts, dim=dim), t, staged)


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
    return _back(out.movedim(0, dim), t, staged)


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
    return _back(recv, t, staged)
