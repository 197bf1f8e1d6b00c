"""AdamW with large-model options, the port of src/repro/training/optim.py:

  - global-norm gradient clipping
  - decoupled weight decay
  - configurable optimizer-state dtype (bf16 states halve memory — used by
    the 1T-class config)
  - adafactor-style *factored second moment* for >=2D params (row+col
    statistics instead of a full tensor — O(n+m) vs O(n*m))
  - linear-warmup + cosine decay schedule

The optimizer walks the reference's parameter leaves, not the port's
tensors: for a `Transformer`, each leaf of `reference_tree` (block tensors
stacked over stages) is stacked, updated whole and copied back into its
blocks, and its state is kept stacked with the reference's shape. The
reference decays and factors by the stacked leaf's rank, so a per-layer
norm scale (D,) is a (num_stages, D) matrix there: decayed, and factored
across layers where `min_factored_size` allows. The state's keys and
shapes are the reference's, which its checkpoints need.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._device import resolve_device, same_device
from repro_torch.models.transformer import StackedLeaf
from repro_torch.training.tree import param_tree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"
    factored: bool = False
    min_factored_size: int = 2 ** 16  # below this, keep the full 2nd moment


def for_model(cfg, **overrides) -> OptimizerConfig:
    return OptimizerConfig(
        state_dtype=cfg.opt_state_dtype,
        factored=cfg.factored_second_moment,
        **overrides,
    )


def schedule(opt: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor), in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return opt.lr * warm * (0.1 + 0.9 * cos)


def _is_factored(shape, opt: OptimizerConfig) -> bool:
    return (opt.factored and len(shape) >= 2
            and shape[-1] * shape[-2] >= opt.min_factored_size)


def init_state(params, opt: OptimizerConfig, device=None) -> dict:
    """Zero states for `params` (a `Transformer` or a tree of tensors) on
    `device` (default: the card), where the parameters must lie:
    {"mu": {leaf path: {"m", "v"} or {"m", "vr", "vc"}}, "step": int32}."""
    dev = resolve_device(device)
    tree = param_tree(params)
    sdt = getattr(torch, opt.state_dtype)

    def leaf(p):
        if not same_device(p.device, dev):
            raise ValueError(f"init_state: a parameter is on {p.device}, "
                             f"the state is asked for on {dev}")
        shape = tuple(p.shape)
        st = {"m": torch.zeros(shape, dtype=sdt, device=dev)}
        if _is_factored(shape, opt):
            st["vr"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
            st["vc"] = torch.zeros(shape[:-2] + shape[-1:],
                                   dtype=torch.float32, device=dev)
        else:
            st["v"] = torch.zeros(shape, dtype=sdt, device=dev)
        return st

    return {"mu": tree_map(leaf, tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, opt: OptimizerConfig):
    """One AdamW step. `grads` is a tree in the reference's layout
    (`training.accumulate.value_and_grad` gives one). A `Transformer`'s
    parameters are updated in place and the module returned; a tree of
    tensors gets a new tree. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    lr = schedule(opt, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - opt.b1 ** step.to(torch.float32)
    bc2 = 1 - opt.b2 ** step.to(torch.float32)

    def leaf(p, g, st):
        pv = p.value() if isinstance(p, StackedLeaf) else p
        g = g.float() * scale
        m = opt.b1 * st["m"].float() + (1 - opt.b1) * g
        if "vr" in st:
            g2 = torch.square(g) + 1e-30
            vr = opt.b2 * st["vr"] + (1 - opt.b2) * g2.mean(-1)
            vc = opt.b2 * st["vc"] + (1 - opt.b2) * g2.mean(-2)
            # rank-1 reconstruction of the second moment
            denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            v = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            nst = {"m": m.to(st["m"].dtype), "vr": vr, "vc": vc}
        else:
            v = (opt.b2 * st["v"].float()
                 + (1 - opt.b2) * torch.square(g))
            nst = {"m": m.to(st["m"].dtype), "v": v.to(st["v"].dtype)}
        upd = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
        if pv.dim() >= 2:
            upd = upd + opt.weight_decay * pv.float()
        newp = (pv.float() - lr * upd).to(pv.dtype)
        if isinstance(p, StackedLeaf):
            p.assign(newp)
            newp = p
        return newp, nst

    tree = param_tree(params)
    out = tree_map(leaf, tree, grads, state["mu"])
    new_mu = tree_map(lambda _, o: o[1], tree, out)
    new_params = (params if tree is not params
                  else tree_map(lambda _, o: o[0], tree, out))
    return new_params, {"mu": new_mu, "step": step}, {
        "grad_norm": gnorm, "lr": lr}
