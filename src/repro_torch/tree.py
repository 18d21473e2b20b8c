"""Nested dicts / lists / tuples of tensors, flattened the way JAX flattens
pytrees, so that the port and ``repro`` name and order leaves alike.

Dict keys are visited in sorted order, sequences by index, ``None`` holds no
leaf, and a leaf's path string equals ``jax.tree_util.keystr`` of its key path
(``['params']['w1']``, ``[0]``).  Everything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    else:
        for i, v in enumerate(node):
            yield f"[{i}]", v


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten_with_path(tree, prefix: str = "",
                      is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's leaf order; ``is_leaf`` stops the
    descent at a node it accepts, as JAX's does (a spec tree's tuples)."""
    if tree is None:
        return []
    if not _is_node(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in _children(tree):
        out.extend(flatten_with_path(child, prefix + part, is_leaf))
    return out


def unflatten(template, leaves: Sequence[Any]):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def map_leaves(fn: Callable[[Any], Any], tree):
    return unflatten(tree, [fn(leaf) for _path, leaf in flatten_with_path(tree)])


def stack_trees(trees: Sequence[Any]):
    """Trees of one structure as one tree whose leaves are their leaves
    stacked along a new leading axis (what a ``lax.scan`` over layers
    returns)."""
    per_tree = [[leaf for _p, leaf in flatten_with_path(t)] for t in trees]
    return unflatten(trees[0], [torch.stack(ts) for ts in zip(*per_tree)])


def index_tree(tree, i):
    """``tree`` with every leaf indexed by ``i`` along its leading axis."""
    return map_leaves(lambda t: t[i], tree)
