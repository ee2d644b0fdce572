"""Minimal pytrees over dict / list / tuple containers.

Stands in for ``jax.tree`` in the port. Leaves are visited in ``jax.tree``
order — dict keys sorted, sequences in order — so a flattened gradient or
model has the same leaf order on both sides of the bridge.

The walks recurse through module-level functions, not nested closures: a
nested function that calls itself is a reference cycle, which would keep
the list of leaves it built (a whole model's tensors) alive until the
garbage collector's next full pass.
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
    _walk_leaves(tree, is_leaf, out)
    return out


def _walk_leaves(t, is_leaf: IsLeaf, out: List[Any]) -> None:
    if is_leaf is not None and is_leaf(t):
        out.append(t)
    elif isinstance(t, dict):
        for k in sorted(t):
            _walk_leaves(t[k], is_leaf, out)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _walk_leaves(v, is_leaf, out)
    else:
        out.append(t)


def leaf_paths(tree) -> List[Tuple[Any, ...]]:
    """The key path of each leaf (dict keys, sequence indices), in
    ``leaves`` order: ``jax.tree_util.tree_flatten_with_path``'s keys."""
    out: List[Tuple[Any, ...]] = []
    _walk_paths(tree, (), out)
    return out


def _walk_paths(t, path, out: List[Tuple[Any, ...]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _walk_paths(t[k], path + (k,), out)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _walk_paths(v, path + (i,), out)
    else:
        out.append(path)


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec): ``unflatten(spec, leaves)`` rebuilds the tree. The
    spec is the tree itself; only its containers are read back."""
    return leaves(tree), tree


def unflatten(spec, new_leaves) -> Any:
    it = iter(new_leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the spec holds")
    return out


def _build(t, it) -> Any:
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


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
