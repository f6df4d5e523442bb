"""Pytree paths and the tree helpers the training path shares.

Port of ``repro/distributed/sharding.py`` :func:`tree_paths` only; the rest
of that module (mesh axes, partition specs, parameter shardings) is TPU-mesh
tooling with no one-card counterpart yet (ROADMAP). A tree here is what the
reference's pytrees are: nested dicts (and lists / tuples) of tensors.
:func:`tree_map`, :func:`tree_leaves` and :func:`tree_unflatten` stand in
for ``jax.tree``'s: like ``jax.tree.map``, :func:`tree_map` rebuilds every
dict with its keys sorted, so a mapped tree's leaves come in the order the
reference's do.
"""
from __future__ import annotations


def tree_paths(tree) -> dict:
    """Flatten a tree to ``{'a/b/c': leaf}`` in the tree's own order."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_paths` order."""
    return list(tree_paths(tree).values())


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; dicts come back with sorted keys, as ``jax.tree.map`` gives
    them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (its own key order) whose leaves are
    ``leaves``, given in :func:`tree_paths` order of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(like)
