"""Parameter trees: nested dicts whose leaves are tensors (or arrays).

The JAX package's parameters are pytrees of nested dicts, and
``jax.tree_util`` visits a dict's entries in sorted-key order at every
level.  These helpers walk the port's trees in that same order, so a tree
flattens here into the reference's leaf order (the ``ModelBank`` column
layout, DESIGN.md §2).  A leaf is anything that is not a dict.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Path = Tuple[str, ...]


def tree_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure (the first
    tree's); a new nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(paths: Sequence[Path], leaves: Sequence[Any]) -> Dict:
    """The nested dict holding ``leaves[i]`` at ``paths[i]``."""
    root: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root
