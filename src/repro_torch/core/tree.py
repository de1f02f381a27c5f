"""Parameter trees: nested dicts, tuples and lists of tensors.

The reference keeps its parameters as JAX pytrees, and its checkpoints,
prune groups and path names all follow ``jax.tree_util`` conventions. This
module reproduces those conventions for plain Python containers so the port
numbers and names leaves exactly as the reference does:

  * dicts flatten in **sorted key order**, tuples and lists in order;
  * ``None`` is an empty subtree (no leaves, kept in the structure);
  * a path renders as ``'/'``-joined tokens, a dict key as itself and a
    sequence index as ``'[i]'`` (``repro.core.pruner._path_name``), e.g.
    ``'layers/[3]/attn/wq/w'``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in JAX flatten order; path tokens are dict keys or
    int sequence indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_name(path: Tuple) -> str:
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def norm_path(name: str) -> str:
    """'layers/[0]/attn/wqkv/w' -> 'layers/0/attn/wqkv/w' (pack keys)."""
    return "/".join(tok.strip("[]") for tok in name.split("/"))


def map_with_path(fn: Callable[[Tuple, Any], Any], tree, path: Tuple = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``;
    containers keep their type and their own key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return tuple(items) if isinstance(tree, tuple) else items
    return fn(path, tree)


def unflatten(like, new_leaves) -> Any:
    """Rebuild ``like``'s structure with ``new_leaves`` in flatten order."""
    index = {path: i for i, (path, _) in enumerate(flatten_with_path(like))}
    if len(index) != len(new_leaves):
        raise ValueError(f"tree has {len(index)} leaves, got "
                         f"{len(new_leaves)}")
    return map_with_path(lambda p, _: new_leaves[index[p]], like)
