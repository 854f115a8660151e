"""Trees of tensors: nested dicts and lists, as the port's parameters and
optimizer state are laid out (``models/convert.py``).  The small part of
``jax.tree_util`` the training path needs: leaves in JAX's order (dict keys
sorted, sequences in order), a map over trees of one structure, and each
leaf's key path as ``repro.train.checkpoint`` spells it (``"a/b/0/c"``)."""

from __future__ import annotations

from collections.abc import Callable


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(path, leaf), ...]`` in flattening order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [pl for key, sub in items
            for pl in leaves_with_paths(sub, f"{prefix}/{key}" if prefix else key)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the ``rest``, which have its
    structure (their dict keys are the same; a mismatch raises), called in
    flattening order."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError(f"trees differ in keys: {sorted(tree)}")
        # visited in flattening order, returned in the tree's own key order
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError(f"trees differ in length: {len(tree)}")
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)
