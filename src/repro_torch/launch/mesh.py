"""Mesh factories, the port of src/repro/launch/mesh.py, and the helper
that runs one function in several ranks.

Functions, not module-level constants, so that importing this module
never touches a process group or a device.

  make_local_mesh     a one-rank mesh: NCCL on the card by default, gloo
                      when the caller names the CPU;
  make_production_mesh  (16, 16) ("data", "model") or (2, 16, 16)
                      ("pod", "data", "model") over the ranks of the
                      default process group, which must have them;
  init_fake_ranks     a fake default process group of n ranks in this
                      process (this process is rank 0; collectives move
                      nothing): what the dry run builds the production
                      mesh on;
  run_in_processes    `fn(rank, world_size, *args)` in `world_size`
                      processes joined by one process group: the
                      counterpart of the reference's
                      `--xla_force_host_platform_device_count` for the
                      tests and `chip_smoke.py`. The group is always gloo:
                      on a machine with one card every rank shares it, and
                      NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_local_mesh(axes: Sequence[str] = ("data", "model"),
                    device=None) -> DeviceMesh:
    """A one-rank mesh (every axis of size 1, everything replicated) on
    `device` (default: the card). Without a process group it starts a
    one-rank default group (NCCL on the card, gloo on the CPU), which the
    caller ends with `torch.distributed.destroy_process_group()`."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"make_local_mesh builds a one-rank mesh; the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (1,) * len(axes),
                            mesh_dim_names=tuple(axes))


def init_fake_ranks(world_size: int) -> None:
    """Starts a fake default process group of `world_size` ranks in this
    process, as rank 0 (`torch.testing._internal.distributed.fake_pg`): its
    collectives return at once and move nothing, so one process can trace
    a step of a 256- or 512-device mesh on fake tensors. A fake group and a
    real one cannot share a process; the caller ends it with
    `torch.distributed.destroy_process_group()`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process; the fake ranks need their own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The dry run's mesh over the default process group's ranks, the first
    256 (or 512) of them, of cards (default) or of the device type of
    `device`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — start "
            f"{n} ranks first (init_fake_ranks({n}) for the dry run)")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def _rank_main(call_path, rank, world_size, store_path, timeout, results):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_in_processes(fn: Callable, world_size: int, *args: Any,
                     store_dir, timeout: float = 120.0) -> List[Any]:
    """`fn(rank, world_size, *args)` in `world_size` fresh processes
    (spawned) joined by one gloo process group over a `FileStore` in
    `store_dir`; returns each rank's result, by rank. `fn` and the results
    must pickle (return numpy arrays, not tensors); `fn` puts its tensors
    on the device it chooses. A rank that raises fails the call with its
    traceback; after `timeout` seconds every process is killed and
    TimeoutError raised."""
    store_path = str(Path(store_dir) /
                     f"filestore-{os.getpid()}-{time.monotonic_ns()}")
    # `fn` and `args` go to the ranks in a file: through spawn's pipe, a
    # start waits for the previous rank to import its modules once they
    # outgrow the pipe's buffer
    call_path = store_path + ".call"
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(call_path, r, world_size, store_path,
                               timeout, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__} in {world_size} ranks "
                                   f"did not finish in {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"{fn.__name__}: rank {dead[0]} "
                                       f"exited {procs[dead[0]].exitcode} "
                                       f"without a result")
                continue
            if not ok:
                raise RuntimeError(f"{fn.__name__}: rank {rank} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:     # each rank exits once its result is sent
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        os.remove(call_path)
    return [out[r] for r in range(world_size)]
