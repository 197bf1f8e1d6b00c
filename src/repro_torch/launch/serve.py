"""Serving launcher: batched generation (optionally RAG-augmented) with the
selected --arch, plus simple request-level continuous batching: a waiting
queue feeds fixed decode slots; finished requests free their slot each step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 12 --batch-slots 4 --new-tokens 16 [--rag]

The port of src/repro/launch/serve.py, with the same arguments. It runs on
the card; `main(argv, device="cpu")` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving.engine import LMServer


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--rag", action="store_true",
                    help="prepend OctopusANN retrievals to each prompt")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         dtype=torch.float32, device=device)
    server = LMServer(params, cfg,
                      max_len=args.prompt_len * 2 + args.new_tokens)

    rng = np.random.default_rng(0)
    queue = [rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32)
             for _ in range(args.requests)]

    retriever = None
    if args.rag:
        from repro_torch.core import build_index, get_preset, make_dataset
        ds = make_dataset("deep-like", n=2048, nq=1, device=device)
        retriever = (build_index(ds, get_preset("octopusann",
                                                memgraph_frac=0.02),
                                 R=16, L_build=32, device=device), ds)

    done, t0 = 0, time.time()
    while queue:
        batch = queue[:args.batch_slots]
        queue = queue[args.batch_slots:]
        prompts = np.stack(batch)
        if retriever is not None:
            idx, ds = retriever
            qvecs = ds.vectors[rng.choice(ds.n, len(batch))]
            res = idx.search(qvecs)
            ctx = (res.ids[:, :args.prompt_len]
                   % cfg.vocab_size).astype(np.int32)
            prompts = np.concatenate([ctx, prompts], axis=1)
        out = server.generate(prompts, new_tokens=args.new_tokens)
        done += len(batch)
        print(f"[serve] completed {done}/{args.requests} "
              f"({done*args.new_tokens/(time.time()-t0):.1f} tok/s)")
    print(f"served {done} requests in {time.time()-t0:.1f}s")
    return done


if __name__ == "__main__":
    main()
