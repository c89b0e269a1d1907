"""A small pytree stack: nested dicts, lists and tuples of leaves.

The JAX package flattens batches and parameter trees with
``jax.tree_util``; the port keeps its own copy of the part it uses, with
the same conventions, so batches and parameter trees flatten to the same
leaf order in both packages:

- a dict's children are visited in sorted key order (and an unflattened
  dict has its keys sorted);
- lists, tuples and NamedTuples are nodes; ``None`` is an empty node;
- anything else (a numpy array, a tensor, a scalar) is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


class TreeDef:
    """The structure of a flattened tree, to rebuild it around new leaves."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any, children: tuple) -> None:
        self.kind = kind  # "leaf" | "none" | "dict" | "list" | "tuple"
        self.meta = meta  # dict keys, or the tuple type
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, TreeDef)
            and (self.kind, self.meta, self.children)
            == (other.kind, other.meta, other.children)
        )

    def __repr__(self) -> str:
        return f"TreeDef({self.kind}, {self.meta!r}, {self.children!r})"


_LEAF = TreeDef("leaf", None, ())


def _flatten(tree: Any, leaves: list) -> TreeDef:
    if tree is None:
        return TreeDef("none", None, ())
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, list):
        return TreeDef("list", None, tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, tuple):
        return TreeDef("tuple", type(tree), tuple(_flatten(x, leaves) for x in tree))
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """→ (leaves in the JAX package's order, structure)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(node: TreeDef) -> Any:
        if node.kind == "leaf":
            return next(it)
        if node.kind == "none":
            return None
        kids = [build(c) for c in node.children]
        if node.kind == "dict":
            return dict(zip(node.meta, kids))
        if node.kind == "list":
            return kids
        if node.meta is tuple:
            return tuple(kids)
        if hasattr(node.meta, "_fields"):  # NamedTuple
            return node.meta(*kids)
        return node.meta(kids)

    return build(treedef)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which must have
    the same structure), rebuilt into that structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {o_def}")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
