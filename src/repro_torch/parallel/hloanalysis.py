"""Trip-count-aware analysis of post-SPMD HLO text.

XLA's ``compiled.cost_analysis()`` counts a while-loop body ONCE, so any
scan-over-layers model under-reports FLOPs by ~num_layers x. This module
parses the optimized HLO, builds the computation call graph (fusion/call/
while/conditional), multiplies while bodies by their ``known_trip_count``
(present in backend_config after XLA loop analysis), and aggregates:

  - flops           : 2 * prod(result_dims) * prod(contracting_dims) per dot
                      (+ convolutions), trip-count weighted
  - traffic_bytes   : HBM-traffic estimate — sum of operand+result bytes of
                      top-level ops (fusion internals excluded: on TPU those
                      stay in registers/VMEM), trip-count weighted
  - collectives     : per-category bytes+counts (all-gather / all-reduce /
                      reduce-scatter / all-to-all / collective-permute),
                      trip-count weighted; result-shape bytes

All numbers are per-device (the SPMD module is the per-device program).

The port's copy of src/repro/parallel/hloanalysis.py, for HLO text from
elsewhere (an XLA dump of the reference, say): it parses the same text to
the same numbers. Torch emits no HLO; the port's dry run counts its local
ops instead (`parallel.opcount`).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "s4": 1, "s8": 1, "s16": 2, "s32": 4, "s64": 8,
    "u4": 1, "u8": 1, "u16": 2, "u32": 4, "u64": 8, "pred": 1,
    "c64": 8, "c128": 16, "token": 0, "s2": 1, "u2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# type may be a tuple containing /*index=N*/ comments (hence the lazy .*?);
# the earliest `word(` after the type is the opcode.
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*?)\s([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(([^)]*)\)\s*->")
_CALLS_RE = re.compile(r"calls=%?([\w\.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w\.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w\.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> List[int]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",") if d]


class Op:
    __slots__ = ("name", "type_str", "opcode", "rest")

    def __init__(self, name, type_str, opcode, rest):
        self.name, self.type_str, self.opcode, self.rest = (
            name, type_str, opcode, rest)


class HloModule:
    def __init__(self, text: str):
        self.comps: Dict[str, List[Op]] = {}
        self.shapes: Dict[str, str] = {}
        self.trip: Dict[str, int] = {}   # body computation name -> trip count
        self.entry: Optional[str] = None
        self._parse(text)

    def _parse(self, text: str):
        cur: Optional[str] = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if not line.startswith(" "):
                # computation header: `%name (params...) -> ret {` — params may
                # contain nested tuple parens, so match loosely
                stripped = line.rstrip()
                if stripped.endswith("{") and "->" in stripped:
                    mc = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)", stripped)
                    if mc:
                        cur = mc.group(1)
                        self.comps[cur] = []
                        if stripped.startswith("ENTRY"):
                            self.entry = cur
                        for pm in re.finditer(r"([\w\.\-]+):\s*([\w\[\],]+)",
                                              stripped.split("->")[0]):
                            self.shapes[pm.group(1)] = pm.group(2)
                        continue
            if line.strip() == "}":
                # computations end; nested ops are indented so this is safe
                continue
            mo = _OP_RE.match(line)
            if not mo or cur is None:
                continue
            name, type_str, opcode, rest = mo.groups()
            self.shapes[name] = type_str.strip()
            op = Op(name, type_str.strip(), opcode, rest)
            self.comps[cur].append(op)
            if opcode == "while":
                mb = _BODY_RE.search(rest)
                mt = _TRIP_RE.search(rest)
                if mb:
                    self.trip[mb.group(1)] = int(mt.group(1)) if mt else 1

    # -- per-op costs ------------------------------------------------------

    def _dot_flops(self, op: Op) -> float:
        out_dims = _shape_dims(op.type_str)
        mc = _CONTRACT_RE.search(op.rest)
        operands = _OPERAND_RE.findall(op.rest.split(")", 1)[0])
        flops = 2.0
        for d in out_dims:
            flops *= d
        if mc and operands:
            lhs_shape = _shape_dims(self.shapes.get(operands[0], ""))
            for idx in mc.group(1).split(","):
                if idx and lhs_shape and int(idx) < len(lhs_shape):
                    flops *= lhs_shape[int(idx)]
        return flops

    def _op_traffic(self, op: Op) -> int:
        b = _shape_bytes(op.type_str)
        operands = _OPERAND_RE.findall(op.rest.split(")", 1)[0])
        for o in operands:
            b += _shape_bytes(self.shapes.get(o, ""))
        return b

    # -- aggregation -------------------------------------------------------

    def analyze(self, entry: Optional[str] = None) -> Dict[str, float]:
        if entry is None:
            entry = self.entry
        if entry is None:
            mains = [c for c in self.comps if c.startswith("main")]
            entry = mains[0] if mains else next(iter(self.comps))

        acc = {"flops": 0.0, "traffic_bytes": 0.0, "transcendentals": 0.0}
        coll: Dict[str, float] = {}
        seen_stack = []

        def walk(comp: str, mult: float):
            if comp not in self.comps or comp in seen_stack:
                return
            seen_stack.append(comp)
            for op in self.comps[comp]:
                oc = op.opcode
                if oc == "while":
                    mb, mc_ = _BODY_RE.search(op.rest), _COND_RE.search(op.rest)
                    trips = self.trip.get(mb.group(1), 1) if mb else 1
                    if mb:
                        walk(mb.group(1), mult * trips)
                    if mc_:
                        walk(mc_.group(1), mult * (trips + 1))
                    acc["traffic_bytes"] += mult * _shape_bytes(op.type_str)
                    continue
                if oc in ("fusion", "call", "async-start"):
                    m = _CALLS_RE.search(op.rest)
                    if m and oc == "call":
                        walk(m.group(1), mult)
                    elif m:  # fusion: count interior dots, traffic at boundary
                        for iop in self.comps.get(m.group(1), ()):
                            if iop.opcode == "dot":
                                acc["flops"] += mult * self._dot_flops(iop)
                            elif iop.opcode in ("exponential", "tanh", "log",
                                                "rsqrt", "power"):
                                acc["transcendentals"] += mult
                    acc["traffic_bytes"] += mult * self._op_traffic(op)
                    continue
                if oc == "conditional":
                    mb = _BRANCHES_RE.search(op.rest)
                    if mb:
                        for c in mb.group(1).split(","):
                            walk(c.strip().lstrip("%"), mult)
                    acc["traffic_bytes"] += mult * self._op_traffic(op)
                    continue
                base = oc.replace("-start", "")
                if base in COLLECTIVE_KINDS:
                    if oc.endswith("-done"):
                        continue
                    b = _shape_bytes(op.type_str)
                    if oc.endswith("-start"):
                        b //= 2  # async tuple type carries (operand, result)
                    coll[base] = coll.get(base, 0.0) + mult * b
                    coll[base + "_count"] = coll.get(base + "_count", 0.0) + mult
                    acc["traffic_bytes"] += mult * b
                    continue
                if oc == "dot":
                    acc["flops"] += mult * self._dot_flops(op)
                    acc["traffic_bytes"] += mult * self._op_traffic(op)
                    continue
                if oc == "convolution":
                    # flops ~= 2 * prod(out) * prod(kernel_spatial) * in_ch
                    out = _shape_dims(op.type_str)
                    operands = _OPERAND_RE.findall(op.rest.split(")", 1)[0])
                    k = (_shape_dims(self.shapes.get(operands[1], ""))
                         if len(operands) > 1 else [])
                    f = 2.0
                    for d in out:
                        f *= d
                    for d in k[:-1]:
                        f *= d
                    acc["flops"] += mult * f
                    acc["traffic_bytes"] += mult * self._op_traffic(op)
                    continue
                if oc in ("parameter", "constant", "tuple", "get-tuple-element",
                          "bitcast", "after-all", "iota"):
                    continue
                acc["traffic_bytes"] += mult * self._op_traffic(op)
            seen_stack.pop()

        walk(entry, 1.0)
        acc["collectives"] = coll
        return acc

    # -- per-op collective profile (hillclimb tool) -------------------------

    def collective_profile(self, entry: Optional[str] = None, top: int = 20):
        """Top collective ops by trip-weighted bytes, with shapes and the
        source op_name metadata — the 'profile' for the §Perf loop."""
        entry = entry or self.entry or next(iter(self.comps))
        rows = []

        def walk(comp, mult, stack):
            if comp not in self.comps or comp in stack:
                return
            stack.append(comp)
            for op in self.comps[comp]:
                oc = op.opcode
                if oc == "while":
                    mb, mc_ = _BODY_RE.search(op.rest), _COND_RE.search(op.rest)
                    if mb:
                        walk(mb.group(1), mult * self.trip.get(mb.group(1), 1),
                             stack)
                    continue
                if oc == "call":
                    m = _CALLS_RE.search(op.rest)
                    if m:
                        walk(m.group(1), mult, stack)
                    continue
                base = oc.replace("-start", "")
                if base in COLLECTIVE_KINDS and not oc.endswith("-done"):
                    b = _shape_bytes(op.type_str)
                    if oc.endswith("-start"):
                        b //= 2
                    mm = re.search(r'op_name="([^"]*)"', op.rest)
                    rows.append({
                        "kind": base, "bytes": b * mult, "mult": mult,
                        "shape": op.type_str[:48],
                        "op_name": (mm.group(1)[-80:] if mm else ""),
                    })
            stack.pop()

        walk(entry, 1.0, [])
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:top]


def analyze_hlo(text: str) -> Dict[str, float]:
    return HloModule(text).analyze()


def collective_profile(text: str, top: int = 20):
    return HloModule(text).collective_profile(top=top)
