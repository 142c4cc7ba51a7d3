"""Small shared utilities: padding arithmetic, nested-dict trees, casting.

Counterpart of ``repro/utils/__init__.py``.  Parameter trees are nested
dicts of tensors; flattening visits keys in sorted order (as JAX flattens
dicts), so a flat leaf list lines up with the JAX package's ``tree_leaves``.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch


def ceil_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def tree_flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` of a nested dict, '/'-joined paths, sorted keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(items) -> dict:
    """Inverse of ``tree_flatten`` for ``[(path, leaf)]`` (or a dict of them)."""
    items = items.items() if isinstance(items, dict) else items
    out: dict = {}
    for path, leaf in items:
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` leafwise with '/'-joined paths, keeping the tree's
    structure, an empty dict included (``jax.tree_util.tree_map_with_path``
    keeps one too, where a flatten and unflatten drops it)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def whole(t: Any) -> Any:
    """A DTensor's whole value as a plain tensor (``full_tensor()``, a
    collective: every rank of its mesh calls it); anything else as it
    is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def count_params(tree: Any) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(tree)
               if hasattr(x, "shape"))


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point tensor leaf to ``dtype``."""
    return tree_map(
        lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x, tree)


def tree_checksum(tree: Any) -> int:
    """Exact checksum of a tree's tensors: the sum of their raw bits read as
    integers.  Chunked, so no leaf is copied whole into a wider dtype; a
    DTensor leaf is gathered whole (``whole``, every rank calls it), one
    leaf at a time."""
    total = 0
    for leaf in tree_leaves(tree):
        flat = whole(leaf).detach().reshape(-1)
        bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        total += sum(int(c.to(torch.int64).sum()) for c in bits.split(1 << 24))
    return total
