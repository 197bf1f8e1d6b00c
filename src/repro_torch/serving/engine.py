"""Serving loop: prefill, then one decode step per new token, with a
fixed-slot batch.

The port of src/repro/serving/engine.py. The reference jits its two step
functions; the port runs them eagerly under `torch.inference_mode()`, on
the device of the parameters. Greedy decoding (`temperature <= 0`) is the
reference's argmax; sampling draws from a `torch.Generator` seeded with
`seed`, a different stream from the reference's `jax.random` one.
`parallel`, a `ParallelContext` or None, goes to both steps. The server
runs on one device or under a context on a one-device mesh: a larger mesh
raises, since serving on it needs that many real ranks (the dry run traces
the steps on fake ones, `launch.dryrun`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import decode_step, init_cache, prefill_step


class LMServer:
    def __init__(self, params, cfg, max_len: int = 512, parallel=None):
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self.parallel = parallel
        self.device = params.device

    def generate(self, prompts: np.ndarray, new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts (B, S) int -> (B, new_tokens) int32 greedy/sampled."""
        if self.parallel is not None and self.parallel.size > 1:
            raise NotImplementedError(
                f"LMServer on a mesh of {self.parallel.size} devices: the "
                f"server runs on one device or a one-device mesh; serving "
                f"on a larger one needs {self.parallel.size} real ranks")
        b, s = prompts.shape
        assert s + new_tokens <= self.max_len
        dev, cfg = self.device, self.cfg
        with torch.inference_mode():
            batch = _batch(cfg, prompts, frames, dev)
            # prefill fills a max_len cache: the prompt's cache goes into
            # the prefix of a max_len buffer
            cache = init_cache(cfg, b, self.max_len, device=dev)
            logits, pf_cache = prefill_step(self.params, cfg, batch,
                                            parallel=self.parallel)
            cache = [_fit(d, c) for d, c in zip(cache, pf_cache)]

            gen = torch.Generator(device=dev).manual_seed(seed)
            out = []
            tok = self._pick(logits, temperature, gen)
            mp0 = (torch.zeros((3, b, 1), dtype=torch.long, device=dev)
                   if cfg.rope_variant == "mrope" else None)
            for i in range(new_tokens):
                out.append(tok)
                logits, cache = decode_step(self.params, cfg, tok[:, None],
                                            cache, s + i,
                                            parallel=self.parallel,
                                            mrope_positions=mp0)
                tok = self._pick(logits, temperature, gen)
            return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @staticmethod
    def _pick(logits, temperature, gen):
        if temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]


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
