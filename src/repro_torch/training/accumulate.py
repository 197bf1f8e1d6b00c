"""Gradients in the reference's parameter tree, and gradient accumulation
(microbatching): the port of src/repro/training/accumulate.py.

`value_and_grad` is `jax.value_and_grad(loss_fn, has_aux=True)` for the
port's parameters: autograd over every parameter of a `Transformer` (or
every tensor of a tree), its gradients stacked into the reference's leaves
(`training.tree.param_tree`). `accumulated_grads` loops over microbatches,
adding each one's f32 gradient divided by their count, and casts the sum to
the parameters' dtype at the end; compression, where on, applies to the
accumulated gradient, once per step.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.transformer import StackedLeaf
from repro_torch.training.tree import param_tree, tree_leaves, tree_map


def _params_of(leaf) -> list:
    return leaf.params if isinstance(leaf, StackedLeaf) else [leaf]


def _placed_as(g, t):
    """The gradient `g` of a DTensor parameter `t` in `t`'s placements
    (a partial sum is reduce-scattered to the parameter's shards)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _flat_grads(loss_fn, params, tree, args, kw):
    """((loss, aux), one gradient per tensor of `tree`'s leaves, in the
    leaves' order), all detached."""
    flat = [t for leaf in tree_leaves(tree) for t in _params_of(leaf)]
    loss, aux = loss_fn(params, *args, **kw)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else _placed_as(g, t)
             for t, g in zip(flat, grads)]
    aux = tree_map(lambda a: a.detach(), aux)
    return (loss.detach(), aux), grads


def _stack(tree, grads):
    """Per-tensor gradients stacked into `tree`'s leaves; each leaf's
    tensors are dropped from `grads` once stacked, so that the two copies
    overlap by one leaf at most."""
    out, i = {}, 0
    for leaf in tree_leaves(tree):
        n = len(_params_of(leaf))
        out[id(leaf)] = (leaf.stack(grads[i:i + n])
                         if isinstance(leaf, StackedLeaf) else grads[i])
        grads[i:i + n] = [None] * n
        i += n
    return tree_map(lambda leaf: out[id(leaf)], tree)


def value_and_grad(loss_fn, params, *args, **kw):
    """((loss, aux), grads) of loss_fn(params, *args, **kw), the gradients
    in the parameters' dtype and in the reference's tree."""
    tree = param_tree(params)
    (loss, aux), grads = _flat_grads(loss_fn, params, tree, args, kw)
    return (loss, aux), _stack(tree, grads)


def accumulated_grads(loss_fn, params, batch, n_micro: int, *loss_args,
                      **loss_kw):
    """batch: dict with leading global-batch dims divisible by n_micro.
    Returns ((loss, aux_of_last_micro), grads) — grads averaged in f32."""
    def split(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    micro = tree_map(split, batch)
    tree = param_tree(params)
    acc, loss_acc, aux = None, None, None
    for i in range(n_micro):
        mb = tree_map(lambda x: x[i], micro)
        (loss, aux), grads = _flat_grads(loss_fn, params, tree,
                                         (mb, *loss_args), loss_kw)
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in grads]
            loss_acc = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
        for a, g in zip(acc, grads):
            a.add_(g.float() / n_micro)
        del grads
        loss_acc = loss_acc + loss / n_micro
    flat = [t for leaf in tree_leaves(tree) for t in _params_of(leaf)]
    grads = [a.to(t.dtype) for a, t in zip(acc, flat)]
    return (loss_acc, aux), _stack(tree, grads)
