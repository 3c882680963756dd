"""Tree helpers over nested dicts/lists of tensors.

Leaf order follows the reference's pytree order (dict keys sorted, lists by
index), so flat layouts and '/'-joined paths match ``repro.utils.tree``.
"""
from __future__ import annotations

import math


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_paths(tree, prefix: str = ""):
    """Flattened ('/'-joined key path, leaf) pairs in reference order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            p = f"{prefix}/{k}" if prefix else str(k)
            out.extend(tree_paths(tree[k], p))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            p = f"{prefix}/{i}" if prefix else str(i)
            out.extend(tree_paths(v, p))
    elif tree is not None:
        out.append((prefix, tree))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(f, tree, *rest):
    """Map ``f`` over the leaves of ``tree`` (and the same-shaped ``rest``);
    ``None`` subtrees stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return f(tree, *rest)


def tree_from_paths(tree, fn, prefix: str = ""):
    """Map ``fn(path, leaf) -> new leaf`` over ``tree``, keeping its
    structure and dict order; paths as ``tree_paths`` gives them, ``None``
    subtrees stay ``None``."""
    sub = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: tree_from_paths(v, fn, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_paths(v, fn, sub(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _rebuild(node, it):
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    if node is None:
        return None
    return next(it)


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` given in reference order.
    (A module-level recursion: a self-referencing closure would form a
    reference cycle that keeps ``leaves`` alive until the cyclic GC runs.)"""
    return _rebuild(like, iter(leaves))


def tree_size(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))
