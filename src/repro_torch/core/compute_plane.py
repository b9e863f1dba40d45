"""Compute plane: per-compute-unit state carried on a leading axis.

PyTorch counterpart of ``repro.core.compute_plane``. Only `replicate` is
ported so far: the batched store stacks one sequence's state B times.
The two-leg (module + NIC) service waits for the replicated store.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves (tensors or arrays) of nested NamedTuples,
    tuples, lists and dicts (None stays None), zipping `rest` trees
    alongside."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `tree_map`'s visiting order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like `like` whose leaves are `leaves`, taken in
    `tree_map`'s visiting order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def replicate(tree, num_units: int):
    """Stack a per-unit state tree C times along a new leading axis."""
    return tree_map(lambda x: torch.stack([x] * num_units), tree)
