"""Fault-tolerant checkpointing, the port of src/repro/training/checkpoint.py,
in the reference's file format:

  - atomic writes (tmp file + rename) so a killed process never leaves a
    half-written checkpoint
  - keep-last-k pruning
  - per-process file naming, `step_{step:08d}.proc{pidx}.npz` beside
    `manifest_{step:08d}.json`, pidx the `torch.distributed` rank (0
    without a process group)
  - the npz keys are the reference's tree paths: a `Transformer` is saved
    as the reference's stacked parameter tree (`reference_tree`), so
    `(params, opt_state)` gives `0/stages/pos0/attn/wq`,
    `1/mu/stages/pos0/ln1/scale/m` and `1/step`, and a checkpoint written
    by either package restores in the other
  - dtypes numpy cannot hold (bfloat16) are stored as float32, exactly,
    and cast back to the target's dtype on restore
  - restore(shardings=) places each leaf onto a mesh as a DTensor (the
    elastic-restart reshard path): every rank reads the one file process 0
    saved and keeps only its own block of each leaf
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device, same_device
from repro_torch.models.transformer import (StackedLeaf, Transformer,
                                            reference_tree)
from repro_torch.parallel.api import NamedSharding, distribute
from repro_torch.training.tree import tree_items, tree_leaves

_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
        t = t.float()      # lossless upcast; restore() casts back
    return t.cpu().numpy()


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _leaves(tree):
    """(path, leaf) of `tree`, a `Transformer` read as the reference's
    stacked tree."""
    for path, leaf in tree_items(tree):
        if isinstance(leaf, Transformer):
            yield from tree_items(reference_tree(leaf), path)
        else:
            yield path, leaf


def _flatten(tree) -> dict:
    return {_key(path): _numpy(leaf.value() if isinstance(leaf, StackedLeaf)
                               else leaf)
            for path, leaf in _leaves(tree)}


def _process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def save(ckpt_dir, step: int, tree: Any, *, keep: int = 3,
         process_index: Optional[int] = None, background: bool = False):
    """Atomic checkpoint write; returns path (or thread if background)."""
    flat = _flatten(tree)   # copied to host memory before returning
    if background:
        th = threading.Thread(
            target=_write, args=(ckpt_dir, step, flat, keep, process_index))
        th.start()
        return th
    return _write(ckpt_dir, step, flat, keep, process_index)


def _write(ckpt_dir, step, flat, keep, process_index):
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    pidx = process_index if process_index is not None else _process_index()
    name = f"step_{step:08d}.proc{pidx}.npz"
    with tempfile.NamedTemporaryFile(dir=d, suffix=".tmp", delete=False) as f:
        np.savez(f, **flat)
        tmp = f.name
    os.replace(tmp, d / name)
    (d / f"manifest_{step:08d}.json").write_text(json.dumps(
        {"step": step, "time": time.time(), "n_arrays": len(flat)}))
    _prune(d, keep)
    return str(d / name)


def _steps(d: Path) -> list:
    return sorted({int(m.group(1)) for p in d.glob("step_*.npz")
                   if (m := re.match(r"step_(\d+)\.", p.name))})


def _prune(d: Path, keep: int):
    for s in _steps(d)[:-keep] if keep else []:
        for p in d.glob(f"step_{s:08d}.*"):
            p.unlink(missing_ok=True)
        (d / f"manifest_{s:08d}.json").unlink(missing_ok=True)


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = _steps(d)
    return steps[-1] if steps else None


def restore(ckpt_dir, target_tree: Any, *, step: Optional[int] = None,
            shardings: Any = None, device=None):
    """Restore into the structure of target_tree on `device` (default: the
    card). A `Transformer` in the target, which must lie on `device`, takes
    the values in place and is returned; every other leaf becomes a new
    tensor of its target's dtype. `shardings`, a tree matching the target's
    with a `parallel.NamedSharding` (or None) at each tensor leaf, places
    those leaves as DTensors on the sharding's mesh, whose device type must
    be `device`'s: each rank copies only its block to the device, with no
    communication. When some leaf carries a sharding, every rank reads the
    file of process 0 (the reference reads `proc{process_index}`, which is
    that file in a one-process run over several devices); otherwise each
    reads its own. Returns (tree, step)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    placed = any(isinstance(s, NamedSharding)
                 for s in tree_leaves(shardings))
    pidx = 0 if placed else _process_index()
    path = Path(ckpt_dir) / f"step_{step:08d}.proc{pidx}.npz"
    with np.load(path) as data:
        return _load(target_tree, data, (), dev, shardings), step


def _load(target, data, prefix, dev, shd=None):
    """`target` restored from `data` on `dev`, placed by the shardings
    `shd` (a matching tree, or None)."""
    if isinstance(target, (list, tuple)):
        return type(target)(
            _load(t, data, prefix + (i,), dev,
                  None if shd is None else shd[i])
            for i, t in enumerate(target))
    if isinstance(target, dict):
        return {k: _load(v, data, prefix + (k,), dev,
                         None if shd is None else shd[k])
                for k, v in target.items()}

    def arr(path):
        return torch.from_numpy(data[_key(path)])

    if isinstance(target, Transformer):
        if shd is not None:
            raise ValueError("restore: a Transformer takes its values in "
                             "place on one device; place tensor leaves "
                             "onto a mesh instead (whole-model DTensors "
                             "come with ROADMAP A11d)")
        if not same_device(target.device, dev):
            raise ValueError(f"restore: the model is on {target.device}, "
                             f"the checkpoint is asked for on {dev}")
        for path, leaf in tree_items(reference_tree(target), prefix):
            leaf.assign(arr(path).to(dev, leaf.dtype))
        return target
    host = arr(prefix)
    if isinstance(target, torch.Tensor):
        host = host.to(target.dtype)
    if shd is None:
        return host.to(dev)
    if shd.mesh.device_type != dev.type:
        raise ValueError(f"restore: {_key(prefix)}'s sharding is on a "
                         f"{shd.mesh.device_type} mesh, the checkpoint is "
                         f"asked for on {dev}")
    return distribute(host, shd, dev)
