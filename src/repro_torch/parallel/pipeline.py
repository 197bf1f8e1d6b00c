"""GPipe-style pipeline parallelism over a mesh axis, the port of
src/repro/parallel/pipeline.py on `torch.distributed`.

At multi-pod scale the inter-pod links are the scarcest resource; pipeline
parallelism sends only layer activations across pods (one (microbatch, seq,
d_model) tensor per stage boundary per tick) instead of gradient or
parameter traffic over the slow axis.

  y = gpipe(stage_fn, stage_params, x, n_micro, axis="pod", mesh=mesh)

  - every rank of `mesh` calls it; the ranks along `axis` are the stages;
  - `stage_params` leaves carry a leading stage axis: DTensors sharded
    over `axis` on it (each rank holds ONLY its stage's parameters), or
    tensors every rank holds whole, of which each stage takes its slice;
  - the reference's tick schedule: at tick t stage s works on microbatch
    t - s, and the activations hop stage -> stage + 1 around a ring of
    point-to-point sends (`parallel.comm.ring_shift`, the `ppermute`); the
    bubble is the standard (S-1)/(M+S-1);
  - the last stage's finished microbatches are shared by an all-reduce of
    the masked buffer (the reference's `psum`).

Where the group's backend cannot move a device tensor (gloo, several ranks
on one card), each hop and the final all-reduce copy through host memory
(`comm.transport` says "gloo-host"); the stage compute stays on the
tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.api import P, local_tensor, mesh_axes
from repro_torch.training.tree import tree_map


def gpipe(stage_fn, stage_params, x: torch.Tensor, n_micro: int, *,
          axis: str, mesh):
    """stage_fn(params_slice, x_micro) -> y_micro, applied as S pipeline
    stages over mesh axis `axis`. x: (B, ...) with B % n_micro == 0, the
    same on every rank. Returns the same-shaped output after all S stages,
    the same on every rank."""
    n_stages = mesh_axes(mesh)[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not a multiple of n_micro {n_micro}")
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    p_stage = tree_map(lambda a: local_tensor(a, mesh, P(axis))[0],
                       stage_params)
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    for t in range(n_micro + n_stages - 1):
        # stage sid works on microbatch (t - sid) when in range; stage 0
        # reads fresh input, the others the handed-over buf
        mb = t - sid
        if 0 <= mb < n_micro:
            y = stage_fn(p_stage, micro[mb] if sid == 0 else buf)
        else:
            y = buf
        # the last stage deposits finished microbatches
        done = t - (n_stages - 1)
        if sid == n_stages - 1 and 0 <= done < n_micro:
            out[done] = y
        buf = comm.ring_shift(y, group)
    # only the last stage wrote into `out`; the others' is still zeros
    out = comm.all_reduce(out, group)
    return out.reshape(b, *x.shape[1:])
