"""Trees of tensors (nested dicts and lists) in the JAX package's leaf order.

``jax.tree_util`` flattens a dict in sorted key order and a list or tuple
in index order, and names a leaf by its path, ``keystr``:
``"['params']['scan'][0]['attn']['wq']"``. The optimizer sums its global
norm in that order and the checkpoint manifest names leaves by those
paths, so a checkpoint of either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

from repro_torch.models.transformer import tree_map

__all__ = ["flatten_with_path", "leaves", "unflatten", "tree_map"]


def flatten_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``'s
    order; ``None`` and empty containers hold no leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in flatten_with_path(x, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in
    :func:`flatten_with_path`'s order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if isinstance(like, dict):
        filled = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}  # det: ok key-addressed; like's order kept
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, it) for x in like)
    if like is None:
        return None
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the structure holds") from None

