"""Trees of parameters, optimizer state and batches: nested mappings, lists
and tuples, walked as ``jax.tree_util`` walks the same pytrees.

One order for every walker of the package: mapping keys sorted, list and
tuple items by index, so a list of leaves (an optimizer's state, a
checkpoint's arrays) means the same thing here and in the JAX package.
``None`` is an empty subtree, as in JAX: :func:`leaves_with_path` skips it
and :func:`tree_map` keeps it. A tree that is built keeps the first input
tree's key order and container types (a mapping becomes a dict).
"""

from typing import Any, Callable, List, Mapping, Sequence, Tuple

Path = Tuple[Any, ...]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching leaves of rest)`` at every leaf of ``tree``;
    the trees of ``rest`` have its structure."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def leaves_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s leaf order; a path
    holds the keys and list indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaves_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten_like(tree: Any, new_leaves: Sequence[Any]) -> Any:
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves`'s order)
    in place of its leaves."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            made = {k: build(node[k]) for k in sorted(node)}
            return {k: made[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out
