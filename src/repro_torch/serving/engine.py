"""Serving loop: prefill, then one decode step per new token, with a
fixed-slot batch.

The port of src/repro/serving/engine.py. The reference jits its two step
functions; the port runs them eagerly under `torch.inference_mode()`, on
the device of the parameters. Greedy decoding (`temperature <= 0`) is the
reference's argmax; sampling draws from a `torch.Generator` seeded with
`seed`, a different stream from the reference's `jax.random` one.
`parallel`, a `ParallelContext` or None, goes to both steps.

On a mesh of more than one real rank (a `DeviceMesh` over a gloo or NCCL
process group) every rank runs `generate` on the same prompts. The server
places the parameters (unless they are DTensors already), the batch and
the serving cache by the sharding rules (`parallel.sharding`), and after
each step lays the cache out by them again. The prompt's cache goes into
the serving cache shard by shard (`layers.write_cache`: the two split the
sequence at different bounds). The logits are gathered whole on every
rank before a token is picked, so that every rank picks the same tokens
from the same seeded generator, and `generate` returns the same array on
every rank. A mesh with no real ranks (the dry run's fake process group,
or a shape-only mesh) raises: the dry run traces the steps there
(`launch.dryrun`).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.convert import place_cache, place_model
from repro_torch.models import decode_step, init_cache, prefill_step
from repro_torch.models.layers import write_cache
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.api import NamedSharding, distribute, from_local


def _on_real_ranks(parallel) -> bool:
    """Whether `parallel`'s mesh has more than one device, each a real
    rank (not a shape-only mesh, not the dry run's fake process group)."""
    return (parallel is not None and parallel.size > 1
            and isinstance(parallel.mesh, DeviceMesh)
            and dist.is_initialized() and dist.get_backend() != "fake")


class LMServer:
    def __init__(self, params, cfg, max_len: int = 512, parallel=None):
        self.cfg, self.max_len, self.parallel = cfg, max_len, parallel
        if _on_real_ranks(parallel) and not isinstance(params.lm_head,
                                                      DTensor):
            params = place_model(params, sh.param_pspecs(parallel, cfg,
                                                         params),
                                 parallel.mesh)
        self.params = params
        self.device = params.device

    def generate(self, prompts: np.ndarray, new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts (B, S) int -> (B, new_tokens) int32 greedy/sampled."""
        ctx = self.parallel
        if ctx is not None and ctx.size > 1 and not _on_real_ranks(ctx):
            raise NotImplementedError(
                f"LMServer on a mesh of {ctx.size} devices needs "
                f"{ctx.size} real ranks (a DeviceMesh over a gloo or NCCL "
                f"process group); a shape-only mesh or the dry run's fake "
                f"ranks only trace the steps (launch.dryrun)")
        b, s = prompts.shape
        assert s + new_tokens <= self.max_len
        ranks = ctx if _on_real_ranks(ctx) else None
        with torch.inference_mode(), (implicit_replication() if ranks
                                      else contextlib.nullcontext()):
            return self._generate(prompts, new_tokens, temperature, seed,
                                  frames, ranks)

    def _generate(self, prompts, new_tokens, temperature, seed, frames,
                  ranks):
        """`generate`'s loop; `ranks` is the context of a mesh of real
        ranks, or None."""
        b, s = prompts.shape
        dev, cfg = self.device, self.cfg
        batch = _batch(cfg, prompts, frames, dev)
        # prefill fills a max_len cache: the prompt's cache goes into the
        # prefix of a max_len buffer
        if ranks is None:
            cache = init_cache(cfg, b, self.max_len, device=dev)
            logits, pf_cache = prefill_step(self.params, cfg, batch,
                                            parallel=self.parallel)
            cache = [_fit(d, c) for d, c in zip(cache, pf_cache)]
        else:
            logits, pf_cache = prefill_step(
                self.params, cfg, place_batch(ranks, cfg, batch, dev),
                parallel=ranks, cache=zero_cache(ranks, cfg, b, s, dev))
            cache = fit_cache(ranks, cfg, zero_cache(
                ranks, cfg, b, self.max_len, dev), pf_cache)

        gen = torch.Generator(device=dev).manual_seed(seed)
        out = []
        tok = self._pick(whole(logits), temperature, gen)
        mp0 = (torch.zeros((3, b, 1), dtype=torch.long, device=dev)
               if cfg.rope_variant == "mrope" else None)
        for i in range(new_tokens):
            out.append(tok)
            step = {"tokens": tok[:, None]}
            if mp0 is not None:
                step["mrope_positions"] = mp0
            if ranks is not None:
                step = place_batch(ranks, cfg, step, dev)
            logits, cache = decode_step(
                self.params, cfg, step["tokens"], cache, s + i,
                parallel=self.parallel,
                mrope_positions=step.get("mrope_positions"))
            if ranks is not None:
                cache = lay_out_cache(ranks, cfg, cache)
            tok = self._pick(whole(logits), temperature, gen)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @staticmethod
    def _pick(logits, temperature, gen):
        if temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]


# ---------------------------------------------------------------------------
# the batch and the caches on a mesh of real ranks, by the sharding rules


def place_batch(ctx, cfg, batch, device=None):
    """Each tensor of `batch` (every rank holds it whole) as a DTensor on
    `ctx`'s mesh placed by `sharding.batch_pspecs`, this rank's block
    copied to `device` (default: the mesh's device type)."""
    specs = sh.batch_pspecs(ctx, cfg, batch)
    return {k: distribute(v, NamedSharding(ctx.mesh, specs[k]), device)
            for k, v in batch.items()}


def zero_cache(ctx, cfg, b, length, device=None, dtype=torch.bfloat16):
    """The zero decode cache of `b` rows and `length` positions (as
    `init_cache` makes it) on `ctx`'s mesh, placed by
    `sharding.cache_pspecs`: each rank makes only its block."""
    meta = init_cache(cfg, b, length, dtype=dtype, device="meta")
    mesh = ctx.mesh
    dev = torch.device(device if device is not None else mesh.device_type)

    def zeros(t, spec):
        shape, _ = compute_local_shape_and_global_offset(
            t.shape, mesh, NamedSharding(mesh, spec).placements)
        return from_local(torch.zeros(shape, dtype=t.dtype, device=dev),
                          mesh, spec, t.shape)

    return place_cache(cfg, meta, sh.cache_pspecs(ctx, cfg, meta), mesh,
                       zeros)


def lay_out_cache(ctx, cfg, cache):
    """`cache`, a decode cache of DTensors, with each tensor laid out as
    `sharding.cache_pspecs` places it (the steps leave their states as
    their products do)."""
    mesh = ctx.mesh
    return place_cache(cfg, cache, sh.cache_pspecs(ctx, cfg, cache), mesh,
                       lambda t, spec: t.redistribute(
                           mesh, NamedSharding(mesh, spec).placements))


def fit_cache(ctx, cfg, dst, src):
    """`src`, the prompt's cache, written into the prefix of `dst`, the
    serving cache, shard by shard (`layers.write_cache`: the two may split
    the sequence at different bounds), and laid out by the rules."""
    def fit(d, c):
        if isinstance(d, dict):
            return {k: fit(d[k], c[k]) for k in d}
        return c if d.shape == c.shape else write_cache(d, c, 0)
    return lay_out_cache(ctx, cfg, [fit(d, c) for d, c in zip(dst, src)])


def whole(t):
    """`t` whole on this rank: a DTensor gathered to Replicate on every
    mesh dim, as a plain tensor; any other tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _batch(cfg, tokens, frames, dev):
    """The prefill batch of `tokens` (B, S): frames (zeros where none are
    given) for the audio front end, positions 0..S-1 on all three M-RoPE
    axes."""
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.frontend == "audio_stub":
        batch["frames"] = (
            torch.as_tensor(np.asarray(frames), device=dev)
            if frames is not None else
            torch.zeros((b, cfg.num_frames, cfg.d_model), device=dev))
    if cfg.rope_variant == "mrope":
        batch["mrope_positions"] = torch.arange(
            s, device=dev)[None, None].expand(3, b, s)
    return batch


def decode_vs_prefill(params, cfg, tokens, frames=None,
                      cache_dtype=torch.bfloat16):
    """(next-token logits after a prefill of the first half of `tokens`
    (B, S) and a decode step for each token of the second half, the full
    prefill's next-token logits), on the parameters' device, with the
    prefill's and decode's caches in `cache_dtype`: the check of
    tests/test_arch_smoke.py::test_decode_matches_prefill."""
    dev = params.device
    b, s = np.shape(tokens)
    batch = _batch(cfg, tokens, frames, dev)
    full, _ = prefill_step(params, cfg, batch)
    half = _batch(cfg, np.asarray(tokens)[:, :s // 2], frames, dev)
    lg, cache = prefill_step(params, cfg, half, cache_dtype=cache_dtype)
    cache = [_fit(d, c) for d, c in zip(
        init_cache(cfg, b, s, dtype=cache_dtype, device=dev), cache)]
    mp = (torch.zeros((3, b, 1), dtype=torch.long, device=dev)
          if cfg.rope_variant == "mrope" else None)
    for i in range(s // 2, s):
        lg, cache = decode_step(params, cfg, batch["tokens"][:, i:i + 1],
                                cache, i, mrope_positions=mp)
    return lg, full


def _fit(dst, src):
    """`src` written into the prefix of `dst`, tree by tree (a KV cache of
    the prompt's length into the serving cache of max_len)."""
    if isinstance(dst, dict):
        return {k: _fit(dst[k], src[k]) for k in dst}
    if dst.shape == src.shape:
        return src
    out = dst.clone()
    out[tuple(slice(0, m) for m in src.shape)] = src.to(dst.dtype)
    return out
