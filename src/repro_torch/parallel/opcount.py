"""Per-device counts of one step, taken from the local ops it runs: the
dry run's counterpart of the reference's `parallel/hloanalysis.py`, which
reads them from XLA's per-device program.

`OpCounter` is a dispatch mode. It lets DTensor turn each op into its
local op on this rank's shards and counts that:

  flops          2·m·n·k of every matrix product (mm, addmm, bmm, baddbmm,
                 convolution, attention), from `torch.utils.flop_counter`'s
                 formulas on the local shapes: the reference counts XLA's
                 dots and convolutions;
  traffic_bytes  the operand and result bytes of every local op that is not
                 a view. In eager mode no op is fused, so this is an upper
                 bound on what a fused program moves;
  collectives    result-shape bytes and a count per category (all-gather,
                 all-reduce, reduce-scatter, all-to-all,
                 collective-permute), DTensor's redistributions and the
                 explicit collectives of `parallel.comm` alike; their bytes
                 are in `traffic_bytes` too, as in the reference;
  peak_bytes     the most bytes that tensors made during the count held at
                 once (views share their base's storage).

DTensor derives each op's output metadata by running it on fake tensors of
the GLOBAL shapes (`torch.distributed.tensor._sharding_prop`); those calls
reach this mode as well and are not counted. DTensor also finds a shard's
offset with small index tensors that it reads back
(`torch.distributed.tensor._utils`, `placement_types`); under a
FakeTensorMode those would be fake and unreadable, so this mode runs them
on real tensors.

`trips(n)` is the loop of the models' sequential scans (the RWKV6 chunks,
the Mamba positions, the attention blocks). Outside a counter it is
`range(n)`. Under a counter that folds loops it runs three iterations
and weighs the second's ops by n - 2, forward and backward: the
counterpart of the reference's trip-count weighting of while bodies
(hloanalysis.py:164-172). The first and the last run as they are: no
gradient flows into the loop's zero initial state, nor out of its final
state where nothing reads it; the second, between them, does what every
middle one does. `unfold(outs, n)` gives the n per-iteration outputs a
folded loop stands for. Folding is only sound on fake tensors, where no
value is read.
"""
from __future__ import annotations

import os
import sys
import weakref
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_PROP_FILE = os.path.join("torch", "distributed", "tensor",
                          "_sharding_prop.py")
_DTENSOR_DIR = os.path.join("torch", "distributed", "tensor", "")

_c10d = torch.ops.c10d
_fc = torch.ops._c10d_functional
COLLECTIVES = {
    _fc.all_gather_into_tensor.default: "all-gather",
    _fc.all_reduce.default: "all-reduce",
    _fc.all_reduce_.default: "all-reduce",
    _fc.reduce_scatter_tensor.default: "reduce-scatter",
    _fc.all_to_all_single.default: "all-to-all",
    _c10d.allreduce_.default: "all-reduce",
    _c10d.allgather_.default: "all-gather",
    _c10d._allgather_base_.default: "all-gather",
    _c10d.reduce_scatter_.default: "reduce-scatter",
    _c10d._reduce_scatter_base_.default: "reduce-scatter",
    _c10d.alltoall_.default: "all-to-all",
    _c10d.alltoall_base_.default: "all-to-all",
    _c10d.send.default: "collective-permute",
}
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, _fc.wait_tensor.default,
         torch.ops.prim.device.default}

_ACTIVE: List["OpCounter"] = []


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _from_offset_arithmetic() -> bool:
    """Whether a DTensor function that finds shard sizes and offsets
    (`..._offset`, `..._offsets`) called this op."""
    f = sys._getframe(2)
    for _ in range(10):
        if f is None:
            return False
        if "offset" in f.f_code.co_name and _DTENSOR_DIR in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROP_FILE):
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts the local ops run inside `with OpCounter() as c:` (see the
    module docstring); `c.record()` returns the totals. `fold_loops` lets
    `trips` fold the models' scans (fake tensors only)."""

    def __init__(self, fold_loops: bool = False):
        # the c10d collectives' fake kernels, for the fake ranks
        import torch.distributed._tools.fake_collectives  # noqa: F401
        super().__init__()
        self.fold_loops = fold_loops
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._weights: List[int] = []
        self._spans: List[tuple] = []      # (first seq nr, end, weight)
        self._node_w: Dict[int, int] = {}

    # -- loop folding ------------------------------------------------------

    def _folded(self, n: int):
        yield 0                    # the first iteration, as it is
        lo = torch._C._autograd._get_sequence_nr()
        self._weights.append(n - 2)
        try:
            yield 1                # a middle one, standing for n - 2
        finally:
            self._weights.pop()
            # the nodes a forward pass made in the middle iteration. Not
            # a checkpoint's recomputation: its nodes never run backward,
            # and it numbers them on the backward's thread (the card's
            # autograd runs there), whose sequence numbers repeat the
            # forward thread's
            if torch._C._current_autograd_node() is None:
                self._spans.append(
                    (lo, torch._C._autograd._get_sequence_nr(), n - 2))
                self._node_w.clear()
        yield 2                    # the last, as it is

    def _weight(self) -> int:
        w = 1
        for n in self._weights:
            w *= n
        node = torch._C._current_autograd_node()
        # a backward function (grad off; checkpoint recomputation runs with
        # grad on and is weighed by its own folded loops)
        if node is not None and not torch.is_grad_enabled():
            seq = node._sequence_nr()
            nw = self._node_w.get(seq)
            if nw is None:
                nw = 1
                for lo, hi, n in self._spans:
                    if lo <= seq < hi:
                        nw *= n
                self._node_w[seq] = nw
            w *= nw
        return w

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live_bytes -= n

    # -- dispatch ----------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs, then its local op
        kwargs = kwargs or {}
        if _from_offset_arithmetic():
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func in _FREE or _in_sharding_propagation():
            return out
        w = self._weight()
        kind = COLLECTIVES.get(func)
        if kind is not None:
            # the c10d ops write their result into their first argument,
            # the functional ones return it
            b = _nbytes(_tensors(args[0] if func.namespace == "c10d"
                                 else out))
            self.collectives[kind] = self.collectives.get(kind, 0) + w * b
            self.collectives[kind + "_count"] = (
                self.collectives.get(kind + "_count", 0) + w)
            self.traffic_bytes += w * b
            return out
        if func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += w * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        outs = _tensors(out)
        self.traffic_bytes += w * (_nbytes(_tensors(args))
                                   + _nbytes(_tensors(list(kwargs.values())))
                                   + (0 if func._schema.is_mutable
                                      else _nbytes(outs)))
        if not func._schema.is_mutable:
            for t in outs:
                self._track(t)
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collectives": dict(self.collectives),
                "peak_bytes": self.peak_bytes}


def trips(n: int):
    """The iterations of a loop whose middle iterations do the same work on
    tensors of the same shapes: `range(n)`, or under an
    `OpCounter(fold_loops=True)` the first three, the second weighed by
    n - 2."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None or not c.fold_loops or n <= 3:
        return range(n)
    return c._folded(n)


def unfold(outs: list, n: int) -> list:
    """The n per-iteration outputs of a loop over `trips(n)`: `outs` as it
    is, or a folded loop's second output standing for every middle one."""
    return outs if len(outs) == n else outs[:1] + outs[1:2] * (n - 2) + \
        outs[2:]
