"""Parameter-tree helpers: nested dicts, lists and tuples of tensors.

Leaves are visited in the JAX package's pytree order (dict keys sorted,
sequences in index order), so a leaf's index and path here are its index and
path there: checkpoints key leaves by the slash-joined path, and stored
optimizer state lists leaves in this order.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

Path = Tuple


def tree_leaves_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, object]]:
    """[(path, leaf)] in JAX flatten order; path components are dict keys
    (str) and sequence indices (int)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_leaves_with_path(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Path = ()):
    """``fn(path, leaf)`` applied leaf-wise."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def path_str(path: Path) -> str:
    """The checkpoint key of a leaf path ("density/planes/0")."""
    return "/".join(str(p) for p in path)
