"""Multi-pod dry run: one step of every (architecture x input shape x mesh)
cell at full production size on fake ranks, with per-device counts; the
port of src/repro/launch/dryrun.py with the same arguments.

The reference lowers and compiles each cell for 256 or 512 host devices
and reads XLA's per-device program. The port starts a fake process group
of 256 ranks, (16, 16) ("data", "model"), or 512, (2, 16, 16) ("pod",
"data", "model") (`launch.mesh.init_fake_ranks`), places the parameters,
the optimizer state and the inputs as DTensors by the sharding rules
(`parallel.sharding`) on fake tensors, so that nothing is allocated, and
runs the step (train: loss, gradients and AdamW; prefill; or one decode
step) under `parallel.opcount.OpCounter`, which counts this rank's local
ops. Each cell writes build/dryrun/<mesh>/<arch>__<shape>.json with:

  flops, traffic_bytes, collectives  per device (OpCounter); the
                       models' scans are folded and weighed by their trip
                       counts, as the reference weighs while bodies;
  memory.argument_bytes  this rank's bytes of the step's arguments
                       (parameters, optimizer state, batch, decode cache);
  memory.output_bytes  this rank's bytes of what the step returns;
  memory.temp_bytes    the most bytes that tensors made by the step held at
                       once;
  trace_s              the seconds the step took to run on fake tensors: it
                       stands for the reference's lower_s and compile_s.

The reference's xla_flops_raw and xla_bytes_raw (XLA's cost analysis,
while bodies counted once) have no counterpart. Torch emits no HLO, so
`parallel.hloanalysis` is not called here; `parse_collectives` is kept
for HLO text from elsewhere.

The decode position is the Python int seq_len - 1: a fake tensor cannot
be read. The step still takes `cur_index` as a 0-d int32 argument, as the
reference's does, and its 4 bytes count among the arguments where the
model reads it (not for the attention-free RWKV6, whose argument XLA
drops).

Usage (records go under build/, which git ignores):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  ...
  (--force to recompute cached records; --tag to write another record set)
On a machine without a card, `main(argv, device="cpu")` traces on fake CPU
tensors.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._device import resolve_device
from repro_torch.configs import (ARCH_IDS, ShapeConfig, applicable_shapes,
                                 get_config, get_shape)
from repro_torch.convert import place_cache, place_model
from repro_torch.launch.mesh import init_fake_ranks, make_production_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import (abstract_params, decode_step, init_cache,
                                init_params, input_specs, loss_fn,
                                prefill_step)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.api import P, ParallelContext, from_local, placements
from repro_torch.parallel.opcount import OpCounter
from repro_torch.training import optim
from repro_torch.training.accumulate import value_and_grad

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

_COLL_RE = re.compile(
    r"\b(f8e4m3fn|f8e5m2|bf16|f16|f32|f64|s4|s8|s16|s32|s64|u8|u16|u32|u64|pred)"
    r"\[([\d,]*)\][^=]*\b"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)\b")
_DTYPE_BYTES = {"f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4,
                "f64": 8, "s4": 1, "s8": 1, "s16": 2, "s32": 4, "s64": 8,
                "u8": 1, "u16": 2, "u32": 4, "u64": 8, "pred": 1}


def parse_collectives(hlo_text: str):
    """Per-device bytes by collective category from post-SPMD HLO.
    Result-shape bytes; -start/-done pairs counted once (via -start)."""
    out = {}
    for line in hlo_text.splitlines():
        if "-done" in line:
            continue
        m = _COLL_RE.search(line)
        if not m:
            continue
        dt, dims, kind = m.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        b = n * _DTYPE_BYTES[dt]
        out[kind] = out.get(kind, 0) + b
        out.setdefault(kind + "_count", 0)
        out[kind + "_count"] += 1
    return out


def pick_profile(cfg, shape) -> str:
    """Auto parallelism profile:
      - train/prefill of sub-8B dense models  -> "fsdp" (pure ZeRO-3)
      - decode when a 16-way TP shard fits    -> "tp"   (no per-token weight
                                                          gathers over data)
      - everything else                        -> "2d"  (FSDP x TP)
    Override with REPRO_PROFILE=2d|fsdp|tp."""
    env = os.environ.get("REPRO_PROFILE")
    if env:
        return env
    if (shape.mode == "train" and cfg.moe is None
            and cfg.param_count() < 8e9):
        return "fsdp"
    if (shape.mode == "prefill" and cfg.moe is None
            and cfg.param_count() < 8e9
            and (cfg.is_attention_free or cfg.num_kv_heads < 16)):
        # full-MHA archs (stablelm-3b kv=32) prefill better under 2d TP
        return "fsdp"
    if shape.mode == "decode" and cfg.param_count() * 2 / 16 < 4e9:
        return "tp"
    return "2d"


def seq_shard(cfg) -> bool:
    """Sequence parallelism pays when the gathered K/V inside attention is
    smaller than the (B,S,D) all-reduce it replaces: GQA (kv < heads),
    attention-free mixers, or models small enough that gathers are noise.
    Off for MoE archs, whose expert parallelism replicates tokens over
    `model`."""
    return (cfg.moe is None
            and (cfg.is_attention_free
                 or cfg.num_kv_heads < cfg.num_heads
                 or cfg.param_count() < 1e9))


# ---------------------------------------------------------------------------
# placing fake tensors


def _fake(meta: torch.Tensor, mesh, spec, device,
          factory=torch.empty) -> DTensor:
    """A DTensor of `meta`'s shape and dtype placed by `spec`, its local
    block made by `factory` on `device` (a fake tensor: call under a
    FakeTensorMode)."""
    with unset_fake_temporarily():
        shape, _ = compute_local_shape_and_global_offset(
            meta.shape, mesh, placements(mesh, spec))
    local = factory(shape, dtype=meta.dtype, device=device)
    return from_local(local, mesh, spec, meta.shape)


def _place_cache(cfg, meta_cache, specs, mesh, device, factory=torch.empty):
    """The per-layer decode cache `meta_cache` as fake DTensors placed by
    `specs` (`sharding.cache_pspecs`, the reference's stacked tree)."""
    return place_cache(cfg, meta_cache, specs, mesh,
                       lambda t, spec: _fake(t, mesh, spec, device, factory))


def _place_tree(tree, specs, mesh, device):
    """A tree of meta tensors as DTensors placed by the same tree of
    specs."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    return _fake(tree, mesh, specs, device)


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor in `tree` (dicts, lists, tuples, a
    module's parameters; a DTensor counts its local block)."""
    if isinstance(tree, nn.Module):
        return local_bytes([p for p in tree.parameters()])
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


# ---------------------------------------------------------------------------
# cells


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run: `step()` runs it on `args` (every
    argument the step takes, for their bytes) under `fake_mode`."""
    step: Callable[[], Any]
    args: Any
    ctx: ParallelContext
    fake_mode: FakeTensorMode


def build_cell(arch: str, shape_name: str, mesh, *, device=None, cfg=None,
               shape=None, remat: Optional[str] = None) -> Cell:
    """The step of (arch, shape_name) on `mesh`, on fake tensors of
    `device`'s type (default: the card). `cfg` and `shape` replace the
    named config and shape (the tests' reduced ones); `remat` the
    REPRO_REMAT policy ("full" by default, as in the reference)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    remat = remat or os.environ.get("REPRO_REMAT", "full")
    ctx = ParallelContext(
        mesh, profile=pick_profile(cfg, shape),
        gather_quant=os.environ.get("REPRO_GATHER_QUANT", "0") == "1",
        seq_shard=seq_shard(cfg))
    specs = input_specs(cfg, shape)
    ameta = abstract_params(cfg)
    pspec = sh.param_pspecs(ctx, cfg, ameta)
    in_pspec = sh.batch_pspecs(ctx, cfg, specs)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        params = place_model(ameta, pspec, mesh,
                             lambda t, spec: _fake(t, mesh, spec, dev))
        if shape.mode in ("train", "prefill"):
            batch = {k: _fake(v, mesh, in_pspec[k], dev)
                     for k, v in specs.items()}

    if shape.mode == "train":
        opt_cfg = optim.for_model(cfg)
        astate = optim.init_state(ameta, opt_cfg, device="meta")
        spspec = sh.opt_state_pspecs(ctx, cfg, astate, pspec)
        with fake_mode:
            state = _place_tree(astate, spspec, mesh, dev)

        def train_step():
            (loss, metrics), grads = value_and_grad(
                loss_fn, params, cfg, batch, parallel=ctx,
                remat_policy=remat)
            new_params, new_state, om = optim.apply_updates(
                params, grads, state, opt_cfg)
            return new_params, new_state, {"loss": loss, **metrics, **om}

        return Cell(train_step, (params, state, batch), ctx, fake_mode)

    if shape.mode == "prefill":
        meta_cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                                device="meta")
        cspec = sh.cache_pspecs(ctx, cfg, meta_cache)

        def prefill():
            cache = _place_cache(cfg, meta_cache, cspec, mesh, dev,
                                 torch.zeros)
            return prefill_step(params, cfg, batch, parallel=ctx,
                                cache=cache)

        return Cell(prefill, (params, batch), ctx, fake_mode)

    # decode
    meta_cache = specs.pop("cache")
    with fake_mode:
        cache = _place_cache(cfg, meta_cache, in_pspec["cache"], mesh, dev)
        tokens = _fake(specs["tokens"], mesh, in_pspec["tokens"], dev)
        cur_index = _fake(specs["cur_index"], mesh, P(), dev)
        mrope = (_fake(specs["mrope_positions"], mesh,
                       in_pspec["mrope_positions"], dev)
                 if "mrope_positions" in specs else None)

    def decode():
        return decode_step(params, cfg, tokens, cache, shape.seq_len - 1,
                           parallel=ctx, mrope_positions=mrope)

    # an attention-free model never reads the position, and XLA leaves an
    # argument the program does not read out of its argument bytes
    args = (params, tokens, cache) + (
        () if cfg.is_attention_free else (cur_index,)) + (
        (mrope,) if mrope is not None else ())
    return Cell(decode, args, ctx, fake_mode)


def count_step(cell: Cell, fold_loops: bool = True) -> dict:
    """Runs `cell`'s step once under an `OpCounter`: its per-device counts,
    memory and trace seconds. `fold_loops=False` runs every iteration of
    the models' scans."""
    t0 = time.time()
    with cell.fake_mode, implicit_replication(), \
            OpCounter(fold_loops=fold_loops) as c:
        out = cell.step()
        out_bytes = local_bytes(out)
    rec = c.record()
    return {
        "trace_s": round(time.time() - t0, 2),
        "flops": rec["flops"],
        "traffic_bytes": rec["traffic_bytes"],
        "collectives": rec["collectives"],
        "memory": {"argument_bytes": local_bytes(cell.args),
                   "output_bytes": out_bytes,
                   "temp_bytes": rec["peak_bytes"]},
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             force=False, device=None):
    """One cell's record, from out_dir/<mesh>/<arch>__<shape>.json when it
    is there (and not `force`), else computed and written there. A failure
    is recorded, not raised. The fake ranks must be running
    (`init_fake_ranks`)."""
    mesh_tag = "multi" if multi_pod else "single"
    out = out_dir / mesh_tag / f"{arch}__{shape_name}.json"
    if out.exists() and not force:
        print(f"[skip cached] {mesh_tag}/{arch}/{shape_name}")
        return json.loads(out.read_text())
    out.parent.mkdir(parents=True, exist_ok=True)
    cfg = get_config(arch)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        cell = build_cell(arch, shape_name, mesh, device=device)
        rec["profile"] = cell.ctx.profile
        rec.update(count_step(cell))
        rec["ok"] = True
        rec["n_devices"] = int(mesh.size())
        coll = sum(v for k, v in rec["collectives"].items()
                   if not k.endswith("count"))
        print(f"[ok] {mesh_tag}/{arch}/{shape_name} ({cell.ctx.profile}): "
              f"trace={rec['trace_s']:.1f}s flops={rec['flops']:.3e} "
              f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
              f"coll={coll/2**30:.2f}GiB")
    except Exception as e:  # record failures — they are bugs to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[FAIL] {mesh_tag}/{arch}/{shape_name}: {type(e).__name__}: {e}")
    rec["total_s"] = round(time.time() - t0, 2)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def hold_against_real_step(arch: str, *, cfg=None, batch: int = 8,
                           seq: int = 128, device=None) -> dict:
    """The dry run's record of `arch`'s training step as the training
    launcher takes it (float32 parameters, AdamW, remat "none", batch x
    seq tokens) on a one-rank mesh, beside the real step on `device`
    (default: the card): FLOPs (`FlopCounterMode` around the real step),
    argument bytes (the real parameters, optimizer state and batch) and
    peak bytes (`torch.cuda.max_memory_allocated` on the card, None on
    the CPU). Needs no process group; the fake one it starts is ended."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or get_config(arch), param_dtype="float32")
    init_fake_ranks(1)
    try:
        mesh = DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        dry = count_step(build_cell(
            arch, "train", mesh, device=dev, cfg=cfg,
            shape=ShapeConfig("train", "train", seq, batch), remat="none"))
    finally:
        dist.destroy_process_group()

    opt = optim.for_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dtype=torch.float32, device=dev)
    state = optim.init_state(model, opt, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev).to(torch.int32)
    args = local_bytes((model, state, tokens))
    step = make_train_step(cfg, opt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(model, state, None, {"tokens": tokens})
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    mem = dry["memory"]
    return {"dry_flops": dry["flops"], "real_flops": fc.get_total_flops(),
            "dry_argument_bytes": mem["argument_bytes"],
            "real_argument_bytes": args,
            "dry_peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
            "real_peak_bytes": peak, "dry_trace_s": dry["trace_s"]}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    out_dir = ART_DIR if not args.tag else ART_DIR.parent / f"dryrun_{args.tag}"
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = n_skip = 0
    for mp in meshes:
        init_fake_ranks(512 if mp == "multi" else 256)
        try:
            for arch in archs:
                cfg = get_config(arch)
                shapes = (applicable_shapes(cfg) if args.shape == "all"
                          else [args.shape])
                for s in shapes:
                    if s not in applicable_shapes(cfg):
                        print(f"[n/a] {arch}/{s} (long-context skip, see "
                              f"DESIGN.md)")
                        n_skip += 1
                        continue
                    rec = run_cell(arch, s, multi_pod=(mp == "multi"),
                                   out_dir=out_dir, force=args.force,
                                   device=dev)
                    if rec.get("ok"):
                        n_ok += 1
                    else:
                        n_fail += 1
        finally:
            dist.destroy_process_group()
    print(f"\ndry-run done: ok={n_ok} fail={n_fail} skipped-n/a={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
