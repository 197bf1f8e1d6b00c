"""Training launcher: train step + checkpoint/restart + straggler monitor +
optional gradient compression, the port of src/repro/launch/train.py with
the same arguments. It runs on the card; `main(argv, device="cpu")` runs
it on the CPU (the reduced --smoke configs train there in seconds).

Die-and-resume drill:
  python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
      --steps 60 --ckpt-dir /tmp/ck --die-at 25    # simulated failure
  python -m repro_torch.launch.train ... --resume  # restarts from step 20

The error-feedback state of --compress-grads is not checkpointed, as in
the reference: a resumed run restarts it from zeros.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import init_params, loss_fn, reference_tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression, optim
from repro_torch.training.accumulate import accumulated_grads, value_and_grad
from repro_torch.training.tree import tree_items


class StragglerMonitor:
    """Flags steps (or, multi-host, peers) slower than 3x the running
    median — on a real cluster this triggers hot-spare promotion; here it
    logs and records (the mitigation hook is the same code path)."""

    def __init__(self, factor=3.0, warmup=5):
        self.times, self.factor, self.warmup = [], factor, warmup
        self.flagged = 0

    def record(self, dt: float):
        self.times.append(dt)
        if len(self.times) > self.warmup:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                self.flagged += 1
                print(f"[straggler] step took {dt*1e3:.0f}ms "
                      f"(median {med*1e3:.0f}ms) — would trigger "
                      f"re-assignment on a cluster")


def make_train_step(cfg, opt_cfg, compress=False, accum=1):
    """step_fn(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics); the `Transformer` is updated in place."""
    def loss(p, b):
        return loss_fn(p, cfg, b, remat_policy="none")

    def step_fn(params, opt_state, err_state, batch):
        if accum > 1:
            (loss_v, _), grads = accumulated_grads(loss, params, batch,
                                                   accum)
        else:
            (loss_v, _), grads = value_and_grad(loss, params, batch)
        if compress:
            grads, err_state = compression.ef_compress_tree(grads, err_state)
        params, opt_state, om = optim.apply_updates(
            params, grads, opt_state, opt_cfg)
        return params, opt_state, err_state, {"loss": loss_v, **om}

    return step_fn


def first_step(cfg, device, compress=False, accum=1, *, steps=20, batch=4,
               seq=32):
    """The first step of a `steps`-step run of `batch` x `seq` tokens, as
    `main` takes it (its optimizer, the pipeline's first batch), from
    float32 parameters drawn on the CPU from seed 0, on `device`: (model,
    error state, metrics). Two devices' steps are compared by
    `step_difference`."""
    dev = resolve_device(device)
    opt = optim.for_model(cfg, lr=1e-3, warmup_steps=10, total_steps=steps)
    toks = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch)).batch(0)["tokens"]
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu").to(dev)
    step = make_train_step(cfg, opt, compress=compress, accum=accum)
    model, _, err, m = step(model, optim.init_state(model, opt, device=dev),
                            compression.init_error_state(model, device=dev),
                            {"tokens": torch.as_tensor(toks, device=dev)})
    return model, err, m


def step_difference(a, b, rtol, atol) -> dict:
    """How far `first_step`'s result `a` lies from `b`'s: the parameters'
    largest difference and its largest excess over rtol, atol (which must
    not be positive), leaf by leaf of the reference's tree.

    With compression an int8 code may round the other way on each device
    where the gradient sits on a rounding boundary; the error-feedback
    residual of such an element differs by a whole quantization step, and
    AdamW's first update g / (|g| + eps) of a code 0 against +-1 moves the
    parameter by up to lr. Those elements ("flips") are allowed lr more."""
    (pa, ea, ma), (pb, eb, mb) = a, b
    lr = float(mb["lr"])
    errs_a, errs_b = dict(tree_items(ea)), dict(tree_items(eb))
    leaves_b = dict(tree_items(reference_tree(pb)))
    diff = excess = 0.0
    flips = n = 0
    for path, leaf in tree_items(reference_tree(pa)):
        x, y = leaf.value().cpu(), leaves_b[path].value().cpu()
        d = (x - y).abs()
        tol = atol + rtol * y.abs()
        if errs_b[path].abs().max() > 0:            # compressed
            e = errs_b[path].cpu()
            flip = (errs_a[path].cpu() - e).abs() > 0.5 * e.abs().max()
            flips += int(flip.sum())
            tol = tol + flip * lr * (1 + 1e-3)
        diff = max(diff, float(d.max()))
        excess = max(excess, float((d - tol).max()))
        n += d.numel()
    return {"loss_a": float(ma["loss"]), "loss_b": float(mb["loss"]),
            "max_abs_param_diff": diff, "max_excess_over_tol": excess,
            "code_flips": flips, "elements": n}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation microbatches")
    ap.add_argument("--die-at", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = optim.for_model(cfg, lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    opt_state = optim.init_state(params, opt_cfg, device=dev)
    err_state = compression.init_error_state(params, device=dev)
    step_fn = make_train_step(cfg, opt_cfg, compress=args.compress_grads,
                              accum=args.accum)

    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        t0 = time.time()
        (params, opt_state), start = ckpt.restore(
            args.ckpt_dir, (params, opt_state), device=dev)
        print(f"[resume] restored step {start} from {args.ckpt_dir} in "
              f"{time.time() - t0:.3f}s", flush=True)

    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    mon = StragglerMonitor()
    losses = []
    for step in range(start, args.steps):
        if step == args.die_at:
            print(f"[failure-sim] dying at step {step} (checkpointed "
                  f"through step {step - step % args.ckpt_every})",
                  flush=True)
            sys.exit(42)
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch(step).items()}
        if cfg.frontend == "audio_stub":
            batch["frames"] = torch.zeros(
                (args.batch, cfg.num_frames, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.rope_variant == "mrope":
            batch["mrope_positions"] = torch.arange(
                args.seq, dtype=torch.int32, device=dev)[None, None].expand(
                    3, args.batch, args.seq)
        params, opt_state, err_state, m = step_fn(
            params, opt_state, err_state, batch)
        loss = float(m["loss"])     # waits for the step's device work
        losses.append(loss)
        mon.record(time.time() - t0)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            t0 = time.time()
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state))
            print(f"[ckpt] saved step {step + 1} in {time.time() - t0:.3f}s",
                  flush=True)
    print(f"done: first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses, "start": start,
                       "straggler_flags": mon.flagged,
                       "step_s": mon.times}, f)
    return losses


if __name__ == "__main__":
    main()
