"""ParallelContext: the single source of truth for mesh-axis decisions.

The port of src/repro/parallel/api.py on `torch.distributed`. Both the
sharding rules (parallel/sharding.py) and the explicit collectives of the
expert-parallel MoE (models/moe.py) consult this object, so the two can
never disagree about where a tensor lives.

The mesh is a `DeviceMesh` whose `mesh_dim_names` are drawn from ("pod",
"data", "model"), or a shape-only mesh: any object whose `shape` is a
dict {axis: size}, which is enough for the rules and needs no ranks. The
context keeps one {axis: size} map (`axes`) for both.

`PartitionSpec` (`P`) is the reference's: one entry per tensor dim, each
None, an axis name, or a tuple of names (the dim split over those axes,
major to minor). A `NamedSharding(mesh, spec)` turns it into DTensor
placements, one per mesh dim: `Shard(d)` on every mesh dim that tensor dim
d names, `Replicate()` on the rest. DTensor splits a dim sharded over
several mesh dims in the mesh's order, major first, so an entry must name
its axes in the mesh's order, as every rule does; another order raises.

`on_shards` runs plain code on each rank's blocks of DTensors, with
`sum_over`, `max_over` and `block_start` for the code that needs the
other ranks: the model (models/) runs its products, attention, scans and
loss so, on the dry run's fake ranks and on real ones.

DTensor moves a tensor between placements in `redistribute` (forward and
backward) and inside its own ops (a norm over split features, a residual
add of a partial sum, a slice of a split sequence), each time through
`redistribute_local_tensor`. Importing this module points that function,
in DTensor's modules, at `_dtensor_move`: under the "gloo-host" transport
(`comm.transport`: card tensors on ranks that share one card over gloo,
which moves CUDA tensors only in `broadcast` and `all_reduce`) it makes
the same move, step for step in DTensor's order, on the local block
through `comm`'s host copies (`_move_local`); under "nccl", "gloo" (CPU
tensors) and "fake" it leaves the move to DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._redistribute import \
    redistribute_local_tensor as _DTENSOR_MOVE
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.parallel import comm

MESH_AXES = ("pod", "data", "model")
# params above this count get their expert d_model FSDP-sharded over `pod`
_POD_FSDP_THRESHOLD = 3e11


class PartitionSpec(tuple):
    """A tuple of per-dim entries, normalised as jax's: an entry of one
    axis name is that name, an empty entry None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis: size} of a `DeviceMesh` or a shape-only mesh, in mesh order."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    else:
        axes = dict(mesh.shape)
    bad = set(axes) - set(MESH_AXES)
    if bad:
        raise ValueError(f"mesh axes {sorted(bad)} are not among "
                         f"{MESH_AXES}")
    return axes


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements, one per mesh dim, of `spec` on `mesh`."""
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"{spec!r} names axis {a!r}, not in the "
                                 f"mesh's {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: entry {entry!r} must name its axes "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec!r} uses axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """`spec` on `mesh`; `placements` are its DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def local_block(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of `t`, a tensor every rank holds whole, under
    `spec`: a view of `t`, found by DTensor's own shard arithmetic. No
    communication."""
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements(mesh, spec))
    for dim, (n, o) in enumerate(zip(shape, offset)):
        t = t.narrow(dim, o, n)
    return t


def local_tensor(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of `t` under `spec`: a DTensor's local tensor (its
    placements must be the spec's), or `local_block` of a tensor every rank
    holds whole."""
    if isinstance(t, DTensor):
        want = placements(mesh, spec)
        if t.device_mesh != mesh or tuple(t.placements) != want:
            raise ValueError(f"a DTensor placed {tuple(t.placements)} is "
                             f"asked for as {spec!r} ({want})")
        return t.to_local()
    return local_block(t, mesh, spec)


def from_local(local: torch.Tensor, mesh: DeviceMesh, spec,
               shape) -> DTensor:
    """The DTensor of global `shape` (contiguous) whose block on this rank
    is `local`, placed by `spec`."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


def distribute(t: torch.Tensor, sharding: NamedSharding,
               device: Optional[torch.device] = None) -> DTensor:
    """A DTensor of `t`, which every rank holds whole (on any device),
    placed by `sharding`: only this rank's block is copied to `device`
    (default: the mesh's device type). No communication."""
    mesh = sharding.mesh
    dev = torch.device(device if device is not None else mesh.device_type)
    local = local_block(t, mesh, sharding.spec).to(dev).contiguous()
    return from_local(local, mesh, sharding.spec, t.shape)


# ---------------------------------------------------------------------------
# running plain code on DTensors, rank by rank


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a DTensor built
    back from a local gradient takes the forward tensor's (contiguous)
    strides, and a later view of it must find them true."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _grad_free(x: DTensor) -> DTensor:
    """`x`, where gradients are off and it asks for one, as a DTensor of
    the same block that does not. DTensor's `redistribute` is an autograd
    Function, which with gradients off detaches in place an output whose
    input asks for a gradient (a parameter, served under
    `inference_mode`), and torch 2.11 has no sharding rule for that
    `detach_` (nor does `inference_mode` allow `x.detach()`)."""
    if torch.is_grad_enabled() or not x.requires_grad:
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def on_shards(fn, mesh, ins, in_placements, out_placements):
    """`fn` on this rank's blocks: each input redistributed to its entry
    of `in_placements` (a plain tensor counts as replicated), `fn` run on
    the local tensors, and each output made a DTensor placed by its entry
    of `out_placements` (`Partial()` where each rank holds its part of a
    sum). Every sharded dim must split evenly. An input whole on a mesh
    dim that splits another input gets each rank's gradient as a partial
    sum there."""
    split = [any(pl[i].is_shard() for pl in in_placements)
             for i in range(mesh.ndim)]
    loc = []
    for x, pl in zip(ins, in_placements):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        grad_pl = [Partial() if s and p == Replicate() else p
                   for s, p in zip(split, pl)]
        loc.append(_ContiguousGrad.apply(
            _grad_free(x).redistribute(mesh, pl).to_local(
                grad_placements=grad_pl)))
    outs = fn(*loc)
    return tuple(DTensor.from_local(o.contiguous(), mesh, pl, run_check=False)
                 for o, pl in zip(outs, out_placements))


def _all_reduce(x, mesh, dims, op):
    """`x` reduced by `op` over the ranks of each of the mesh dims `dims`,
    through `comm` under "gloo-host", else a functional collective."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        group = mesh.get_group(i)
        if comm.transport(group, x.device) == "gloo-host":
            x = comm.all_reduce(x, group, op)
        else:
            x = funcol.all_reduce(x, op, (mesh, i))
    return x


def _chunk_size(n: int, k: int, i: int) -> Tuple[int, int]:
    """(size, offset) of chunk `i` of `k` of a dim of `n`, as
    `torch.chunk` cuts it (and DTensor with it)."""
    full = -(-n // k)
    lo = min(n, full * i)
    return max(0, min(n, lo + full) - lo), lo


def _move_local(local, mesh, src, dst, shape):
    """This rank's block of a tensor of global `shape` placed `src` on
    `mesh`, moved to the placements `dst` (DTensor's greedy plan, through
    `comm`)."""
    for a, b in zip(src, dst):
        for p in (a, b):
            if type(p) not in (Shard, Replicate, Partial):
                raise NotImplementedError(f"no block move of a {p}")
    if src == dst:
        return local
    coord = mesh.get_coordinate()
    # the logical shape each mesh dim splits: the whole, less the splits
    # of the mesh dims before it
    logical = [list(shape)]
    for i, p in enumerate(src[:-1]):
        cur = list(logical[i])
        if isinstance(p, Shard):
            cur[p.dim] = _chunk_size(cur[p.dim], mesh.size(i), coord[i])[0]
        logical.append(cur)
    steps = []
    cur = list(src)
    if any(isinstance(p, Shard) and mesh.size(i) > 1
           for i, p in enumerate(src)):
        # inner mesh dims first, a nested split gathered before it is cut
        # again (DTensor's greedy plan)
        for i in reversed(range(len(cur))):
            tgt = dst[i]
            if isinstance(tgt, Shard):
                before = [j for j in range(i) if cur[j] == Shard(tgt.dim)]
                after = [j for j in range(i) if dst[j] == Shard(tgt.dim)]
                if before != after:
                    tgt = Replicate()
            if cur[i] != tgt:
                steps.append((i, cur[i], tgt))
                cur[i] = tgt
    for i in range(len(cur)):
        if cur[i] != dst[i]:
            steps.append((i, cur[i], dst[i]))
            cur[i] = dst[i]
    for i, a, b in steps:
        n = mesh.size(i)
        if n == 1:
            continue
        group = mesh.get_group(i)
        if b.is_partial():
            # a replicated value as partial values (DTensor's dispatcher
            # does this before some ops): each rank's share of the sum
            if not isinstance(a, Replicate):
                raise ValueError(f"no move from {a} to {b}")
            local = local / n if b.reduce_op == "sum" else local
        elif a.is_partial():
            op = "sum" if a.reduce_op == "avg" else a.reduce_op
            if isinstance(b, Replicate):
                local = comm.all_reduce(local, group, op)
            elif op == "sum":
                local = _reduce_scatter(local, group, b.dim, n, coord[i])
            else:
                local = _split(comm.all_reduce(local, group, op), b.dim, n,
                               coord[i])
            if a.reduce_op == "avg":
                local = local / n
        elif isinstance(b, Replicate):
            local = _gather(local, group, a.dim, logical[i][a.dim], n)
        else:
            if isinstance(a, Shard):
                local = _gather(local, group, a.dim, logical[i][a.dim], n)
            local = _split(local, b.dim, n, coord[i])
    return local


def _split(local, dim, n, me):
    """Chunk `me` of `n` of `local` along `dim`, as a new tensor."""
    size, lo = _chunk_size(local.shape[dim], n, me)
    return local.narrow(dim, lo, size).clone(
        memory_format=torch.contiguous_format)


def _gather(local, group, dim, n_dim, n):
    """The whole of a dim of `n_dim` split `n` ways, from each member's
    chunk (padded to the largest for the collective)."""
    full = -(-n_dim // n)
    pad = full - local.shape[dim]
    if pad:
        local = torch.cat([local, local.new_zeros(
            local.shape[:dim] + (pad,) + local.shape[dim + 1:])], dim)
    out = comm._all_gather(local, group, dim)
    return out.narrow(dim, 0, n_dim) if full * n != n_dim else out


def _reduce_scatter(local, group, dim, n, me):
    """This member's chunk of `dim` of the sum of the members' `local`."""
    n_dim = local.shape[dim]
    full = -(-n_dim // n)
    if full * n != n_dim:
        local = torch.cat([local, local.new_zeros(
            local.shape[:dim] + (full * n - n_dim,) + local.shape[dim + 1:])],
            dim)
    out = comm.reduce_scatter(local, group, dim)
    return out.narrow(dim, 0, _chunk_size(n_dim, n, me)[0])


def _dtensor_move(local, current_spec, target_spec, *args, **kwargs):
    """DTensor's move of a local block (in `redistribute`, its backward,
    and before an op whose inputs are placed otherwise than the op needs):
    through `_move_local` under "gloo-host", where DTensor's collectives
    cannot move card tensors, DTensor's own otherwise."""
    mesh = current_spec.mesh
    if comm.transport(mesh.get_group(0), local.device) == "gloo-host":
        comm.host_stats["dtensor_moves"] += 1
        return _move_local(local, mesh, tuple(current_spec.placements),
                           tuple(target_spec.placements), current_spec.shape)
    return _DTENSOR_MOVE(local, current_spec, target_spec, *args, **kwargs)


def _route_dtensor_moves():
    """Points DTensor's modules that move local blocks at `_dtensor_move`
    (once per process)."""
    from torch.distributed.tensor import _api, _dispatch, _redistribute
    for module in (_api, _dispatch, _redistribute):
        if module.redistribute_local_tensor is _DTENSOR_MOVE:
            module.redistribute_local_tensor = _dtensor_move


class _SumOver(torch.autograd.Function):
    """The sum of a local tensor over the ranks of some mesh dims (an
    all-reduce); its gradient is the result's, which every rank holds."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, mesh, dims, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x, mesh, dims):
    """`x` summed over the ranks of the mesh dims `dims`."""
    return _SumOver.apply(x, mesh, tuple(dims)) if dims else x


class _SumGradOver(torch.autograd.Function):
    """The identity, whose gradient is summed over the ranks of some mesh
    dims."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.dims, "sum"), None, None


def sum_grad_over(x, mesh, dims):
    """`x`, whose gradient is summed over the ranks of the mesh dims
    `dims`: where each rank's gradient of a tensor they all hold is its
    part of the whole (its tokens', its experts')."""
    dims = tuple(i for i in dims if mesh.size(i) > 1)
    if not dims or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _SumGradOver.apply(x, mesh, dims)


def max_over(x, mesh, dims):
    """`x`'s elementwise max over the ranks of the mesh dims `dims` (no
    gradient)."""
    return _all_reduce(x.detach(), mesh, dims, "max")


def block_start(mesh, pl, dim: int, n_local: int) -> int:
    """Where this rank's block of `dim` starts, under placements `pl`
    (DTensor splits a dim over several mesh dims major first)."""
    lo = 0
    for i, p in enumerate(pl):
        if p == Shard(dim):
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    return lo * n_local


def reduced(x, like=None):
    """`x` with any partial sum of a DTensor reduced over its ranks, as XLA
    reduces a dot's partial sums before a nonlinearity: an all-reduce, or,
    where `like` (a parameter along `x`'s last dim) is split, a
    reduce-scatter to that split of the last dim. `x` itself otherwise."""
    if not (isinstance(x, DTensor)
            and any(p.is_partial() for p in x.placements)):
        return x
    split = ([q == Shard(like.ndim - 1) for q in like.placements]
             if isinstance(like, DTensor) else [False] * len(x.placements))
    want = [(Shard(x.ndim - 1) if s else Replicate()) if p.is_partial()
            else p for p, s in zip(x.placements, split)]
    return x.redistribute(x.device_mesh, want)


def along_features(v, x):
    """`v`, a parameter whose last dim lines up with `x`'s last dim (a norm
    scale, a bias, a mixing coefficient), laid out as `x`'s last dim: split
    where it is, whole elsewhere, as XLA gathers such small weights. Left
    to DTensor's costs, a product with it may move the activation instead
    (torch 2.11 gathered the batch and split the features 512 ways). `v`
    itself unless both are DTensors."""
    if not (isinstance(v, DTensor) and isinstance(x, DTensor)):
        return v
    want = tuple(Shard(v.ndim - 1) if p == Shard(x.ndim - 1) else Replicate()
                 for p in x.placements)
    if tuple(v.placements) == want:
        return v
    return _grad_free(v).redistribute(v.device_mesh, want)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """profile:
      "2d"   — FSDP x TP (batch over (pod,data), weights (data, model)) —
               the right scheme for TP-worthy models and for decode latency.
      "fsdp" — pure ZeRO-3: batch AND params sharded over every mesh axis,
               no tensor parallelism — the right scheme for <8B dense models
               on a 256-chip pod, where TP=16 activation all-reduces dwarf
               FSDP param gathers.
      "tp"   — weights over `model` only (decode).
    gather_quant: fp8 weight gathers for the MoE FSDP path.
    seq_shard: sequence parallelism (off for MoE archs — their EP design
    token-replicates over model).
    """
    mesh: Any
    profile: str = "2d"          # "2d" | "fsdp" | "tp"
    gather_quant: bool = False
    seq_shard: bool = True
    axes: Dict[str, int] = dataclasses.field(init=False, repr=False,
                                             compare=False)

    def __post_init__(self):
        object.__setattr__(self, "axes", mesh_axes(self.mesh))

    @property
    def size(self) -> int:
        return self.axes_size(tuple(self.axes))

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    def has_axis(self, name: str) -> bool:
        return self.axes.get(name, 1) > 1

    def axis_size(self, name: str) -> int:
        return self.axes.get(name, 1)

    def axes_size(self, names: Sequence[str]) -> int:
        n = 1
        for a in names:
            n *= self.axis_size(a)
        return n

    def batch_axes(self, batch: int) -> Tuple[str, ...]:
        """Largest divisible prefix of the profile's data axes."""
        cands = ([("pod", "data", "model"), ("data", "model"),
                  ("pod", "data"), ("data",)]
                 if self.profile == "fsdp" else
                 [("pod", "data"), ("data",)])
        for axes in cands:
            if not all(a in self.axes for a in axes):
                continue
            if batch % self.axes_size(axes) == 0 and self.axes_size(axes) > 1:
                return axes
        return ()

    def fsdp_weight_axes(self, dim: int):
        """Best divisible axis combo for ZeRO-3 weight sharding."""
        for axes in (("pod", "data", "model"), ("data", "model"),
                     ("data",), ("model",)):
            if (all(a in self.axes for a in axes)
                    and dim % self.axes_size(axes) == 0):
                return axes
        return None

    def dp_spec(self, batch: int):
        ax = self.batch_axes(batch)
        return ax if ax else None

    def divides(self, dim: int, axes) -> bool:
        if axes is None:
            return True
        if isinstance(axes, str):
            axes = (axes,)
        return dim % self.axes_size(axes) == 0

    def moe_weight_axes(self, cfg) -> dict:
        """How expert weights (E, d_model, d_ff) are sharded beyond EP."""
        d_ff_ax = None
        if (self.profile != "tp" and self.has_axis("data")
                and cfg.moe.d_ff_expert % self.axis_size("data") == 0):
            d_ff_ax = "data"
        d_model_ax = None
        if (self.multi_pod and cfg.param_count() > _POD_FSDP_THRESHOLD
                and cfg.d_model % self.axis_size("pod") == 0):
            d_model_ax = "pod"
        return {"d_ff": d_ff_ax, "d_model": d_model_ax}

    def sharding(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    def constrain(self, x, *spec):
        """`x` laid out as `spec`: `x` itself on a one-device mesh; on a
        larger one a DTensor redistributed to the spec's placements. A
        plain tensor there raises: its layout is unknown."""
        if self.size == 1:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(
                f"constrain on a mesh of {self.size} devices needs a "
                f"DTensor, not a {type(x).__name__}")
        return _grad_free(x).redistribute(self.mesh,
                                          placements(self.mesh, spec))

    def constrain_tokens_major(self, x, batch: int):
        """Activation layout between blocks: batch -> (pod, data); under the
        2d profile the SEQUENCE dim is additionally sharded over `model`
        (Megatron-style sequence parallelism: it turns the per-layer
        (B,S,D) all-reduce into gathers of the much smaller GQA K/V tensors
        inside attention)."""
        dp = self.batch_axes(batch)
        seq_ax = None
        if (self.profile in ("2d", "fsdp") and self.seq_shard and x.ndim == 3
                and self.has_axis("model")
                and "model" not in (dp or ())
                and x.shape[1] % self.axis_size("model") == 0
                and x.shape[1] > 1):
            # 2d: Megatron sequence parallelism. fsdp-prefill: the batch may
            # not cover (data x model); without seq-sharding the model axis
            # would idle
            seq_ax = "model"
        if x.ndim == 3:
            return self.constrain(x, dp if dp else None, seq_ax, None)
        return self.constrain(x, dp if dp else None,
                              *([None] * (x.ndim - 1)))


_route_dtensor_moves()
