"""Lane packing over nested dicts of tensors (the part of
``repro.core.packing`` that serving uses).

A "lane" is one slot of a stacked axis: co-resident requests (or the layers
of a stack) are index ``i`` of every leaf. ``axis`` names that axis; the
reference always stacks on axis 0, and the serving pool stacks lanes on the
batch axis (1) of the per-layer caches. Reads return views; ``tree_set_lane``
writes in place (the reference's ``.at[i].set`` returns a copy).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def stack_trees(trees: Sequence[Any], axis: int = 0) -> Any:
    """Stack a list of identical-structure trees on a new axis."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def lane_slice(tree: Any, i: int, axis: int = 0) -> Any:
    """Lane ``i`` of every leaf, as views."""
    return _tree_map(lambda x: x.select(axis, i), tree)


def tree_get_lane(tree: Any, i: int, axis: int = 0) -> Any:
    """Read lane ``i`` of a stacked tree."""
    return lane_slice(tree, i, axis)


def tree_set_lane(tree: Any, i: int, lane: Any, axis: int = 0) -> Any:
    """Write ``lane`` into slot ``i`` of a stacked tree, in place."""
    _tree_map(lambda pool, x: pool.select(axis, i).copy_(x), tree, lane)
    return tree
