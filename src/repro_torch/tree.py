"""Nested dicts / lists / tuples of tensors, flattened the way JAX flattens
pytrees, so that the port and ``repro`` name and order leaves alike.

Dict keys are visited in sorted order, sequences by index, ``None`` holds no
leaf, and a leaf's path string equals ``jax.tree_util.keystr`` of its key path
(``['params']['w1']``, ``[0]``).  Everything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    else:
        for i, v in enumerate(node):
            yield f"[{i}]", v


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's leaf order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in _children(tree):
        out.extend(flatten_with_path(child, prefix + part))
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
