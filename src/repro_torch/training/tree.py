"""Trees of tensors walked as `jax.tree` walks them: nested dicts in sorted
key order, tuples and lists by index, anything else a leaf.

The training modules keep gradients, optimizer states and error states in
the reference's parameter tree (`models.transformer.reference_tree`), so
these walks visit, name and sum their leaves in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

from repro_torch.models.transformer import Transformer, reference_tree


def param_tree(params) -> Any:
    """`params` as the reference's tree: a `Transformer` read through
    `reference_tree` (leaves are `StackedLeaf`s), any other tree as it is."""
    return reference_tree(params) if isinstance(params, Transformer) else params


def tree_items(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in jax's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching nodes of `rest`: the
    first tree's structure decides where the leaves are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
