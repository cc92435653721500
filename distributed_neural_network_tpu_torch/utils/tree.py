"""Nested dicts and lists of tensors as trees, flattened in the JAX package's
order (`jax.tree.leaves`: dict keys sorted, sequences in order), so that a
JAX tree and its port carry across leaf by leaf."""

from __future__ import annotations


def is_node(x) -> bool:
    """A dict, list or tuple (not a subclass such as a PartitionSpec): a
    node of the tree; anything else is a leaf."""
    return type(x) in (dict, list, tuple)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if is_node(tree):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if is_node(node):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and the leaves of `rest` at the same
    places), in the shape of `tree`."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *others)])
