"""``jax.tree``'s flatten, unflatten and map for the port's containers.

The trainer's parameters, gradients and optimizer state are nested dicts,
lists, tuples and NamedTuples of tensors.  Leaves are ordered as
``jax.tree.flatten`` orders them: dict keys sorted, sequences and
NamedTuple fields in order, and ``None`` is no leaf.  So the checkpointer
writes a tree's arrays in the order the reference writes the same tree's,
and the optimizer sums the global norm in the reference's leaf order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaves", "flatten", "unflatten", "tree_map"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree, is_leaf: Optional[Callable] = None
            ) -> Tuple[List[Any], Any]:
    """(leaves in jax order, the tree itself as its structure);
    ``is_leaf`` stops the walk at a node, as ``jax.tree.flatten``'s."""
    out: List[Any] = []

    def walk(node):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append(node)
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            for child in node:
                walk(child)
        else:
            out.append(node)
    walk(tree)
    return out, tree


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(structure, new_leaves,
              is_leaf: Optional[Callable] = None) -> Any:
    """``structure`` (a tree) with its leaves replaced, in order, by
    ``new_leaves`` (``is_leaf`` as ``flatten``'s)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            rebuilt = {key: build(node[key]) for key in sorted(node)}
            return {key: rebuilt[key] for key in node}
        if _is_namedtuple(node):
            return type(node)(*(build(child) for child in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)
    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (each of ``tree``'s structure)."""
    flat = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
