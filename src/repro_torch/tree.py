"""Minimal pytrees over dict / list / tuple containers.

Stands in for ``jax.tree`` in the port. Leaves are visited in ``jax.tree``
order — dict keys sorted, sequences in order — so a flattened gradient or
model has the same leaf order on both sides of the bridge.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

IsLeaf = Optional[Callable[[Any], bool]]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order. ``is_leaf`` marks containers
    that count as one leaf, as in ``jax.tree``."""
    out: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(tree)
    return out


def leaf_paths(tree) -> List[Tuple[Any, ...]]:
    """The key path of each leaf (dict keys, sequence indices), in
    ``leaves`` order: ``jax.tree_util.tree_flatten_with_path``'s keys."""
    out: List[Tuple[Any, ...]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append(path)

    walk(tree, ())
    return out


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec): ``unflatten(spec, leaves)`` rebuilds the tree. The
    spec is the tree itself; only its containers are read back."""
    return leaves(tree), tree


def unflatten(spec, new_leaves) -> Any:
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the spec holds")
    return out


def map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None) -> Any:  # noqa: A001 - mirrors jax.tree.map
    """``fn`` over corresponding leaves of trees of one structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError("tree.map: dict keys differ")
        return {k: map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree)
               for r in rest):
            raise ValueError("tree.map: sequence structure differs")
        return type(tree)(map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest))
    if any(_is_node(r) for r in rest):
        raise ValueError("tree.map: leaf against container")
    return fn(tree, *rest)


def to_device(tree, device) -> Any:
    """Every leaf as a tensor on ``device``, its dtype kept: tensors are
    moved (a no-op where they already are), numpy arrays — the leaves of a
    message decoded off the wire — are copied in."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.array(x)).to(device)
    return map(one, tree)
