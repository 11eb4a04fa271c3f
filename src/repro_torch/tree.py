"""Nested dicts, lists and tuples of tensors (the port's parameter,
gradient and optimizer-state trees), walked in the reference's pytree
order: dict keys sorted, sequences in order, ``None`` an empty subtree."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Mapping


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in pytree order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure); dicts come back with sorted
    keys, sequences as lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: Iterable[Any]) -> Any:
    """``tree``'s structure holding ``leaves`` (in pytree order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
