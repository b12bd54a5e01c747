"""Helpers over nested dicts of tensors (the port's parameter trees).

A tree is a dict whose values are dicts or leaves; a ``NamedTuple`` of
trees (``TrainState``, ``OptState``) is walked field by field. ``None``
is a leaf-free subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); keeps the structure."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global l2 norm over all leaves (fp32 accumulation), a 0-d tensor on
    the leaves' device."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def flatten_dict(d: Any, sep: str = "/", prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict (or NamedTuple) into {'a/b/c': leaf}."""
    if _is_namedtuple(d):
        d = d._asdict()
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping) or _is_namedtuple(v):
            out.update(flatten_dict(v, sep=sep, prefix=key))
        elif v is not None:
            out[key] = v
    return out


def unflatten_dict(d: Mapping[str, Any], sep: str = "/") -> dict:
    """Inverse of :func:`flatten_dict` (NamedTuples come back as dicts)."""
    out: dict = {}
    for k, v in d.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """:func:`tree_map` where ``fn`` also receives the slash-joined path of
    the leaf (dict keys and NamedTuple field names, as ``repro``'s
    ``map_with_path`` joins them)."""
    if tree is None:
        return None
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, join(f)) for f, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def tree_paths(tree: Any) -> list:
    """The slash-joined path of every leaf, in :func:`tree_leaves`' order."""
    out: list = []
    map_with_path(lambda p, x: out.append(p), tree)
    return out
