"""Nested containers of tensors ("trees"): the few tree operations the
optimizer and the checkpoints need.

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (an empty
subtree), or a leaf (anything else, usually a tensor).  Leaves are ordered
as the reference flattens its pytrees: dict entries by sorted key, sequences
and NamedTuple fields in order.  So a checkpoint's leaf files line up with
the reference's, and :func:`describe` writes the reference's structure
string.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list:
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    if tree is None:
        return []
    if _is_node(tree):
        return [leaf for child in _children(tree) for leaf in leaves(child)]
    return [tree]


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) for the leaves of ``tree`` in flattening order; a path
    joins dict keys, sequence indices and NamedTuple field names with "/",
    e.g. ``"layers/0/attn/wq/w"``."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        names = sorted(tree)
    elif _is_namedtuple(tree):
        names = tree._fields
    else:
        names = range(len(tree))
    return [pair for name, child in zip(names, _children(tree))
            for pair in leaves_with_paths(child, f"{prefix}/{name}" if prefix else str(name))]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if _is_node(node):
            return _rebuild(node, [build(c) for c in _children(node)])
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 - the tree map
    """``fn`` applied leaf by leaf to ``tree`` and the equally-structured
    ``rest``."""
    if tree is None:
        return None
    if _is_node(tree):
        kids = zip(_children(tree), *(_children(r) for r in rest))
        return _rebuild(tree, [map(fn, *k) for k in kids])
    return fn(tree, *rest)


def describe(tree) -> str:
    """The structure as the reference's ``str(treedef)`` writes it, e.g.
    ``PyTreeDef({'latent': [*, *], 'opt': CustomNode(namedtuple[AdamWState],
    [*, [*, *], [*, *], [*, *]])})``."""

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            inner = ", ".join(walk(c) for c in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"
