"""Nested dicts, lists and tuples of tensors as flat dicts by path: dict
keys in sorted order, list and tuple positions, joined by dots
(``"stages.0.0.attn.wq"``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional


def paths(tree, is_leaf: Optional[Callable] = None, prefix: str = "") -> Dict:
    if is_leaf is not None and is_leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(paths(tree[k], is_leaf, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(paths(x, is_leaf, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def is_cache_leaf(x) -> bool:
    """A tree cache's leaf: ``{"q": rows, "scale": scales}`` (or just q)."""
    return isinstance(x, dict) and "q" in x
