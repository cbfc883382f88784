"""Carrying parameters between the JAX package and the port.

The JAX engines ravel a parameter pytree with `ravel_pytree`, whose order is
the pytree's leaf order: lists and tuples in order, dicts by sorted key. For
the MLP's list of ``{"w", "b"}`` dicts that is, per layer, **b first, then
w**, each row-major. `ravel`/`unravel` keep that order, so both packages
compute on the same flat vector `w`; `tree_map` walks a structure in that
order (the tree layout), and `tree_cache_from_jax` brings a JAX tree
cache or carry across.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch


def leaves(params, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves of a params structure in JAX's flattening order; a node
    for which `is_leaf` holds is a leaf."""
    if is_leaf is not None and is_leaf(params):
        return [params]
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in leaves(params[k], is_leaf)]
    if isinstance(params, (list, tuple)):
        return [x for p in params for x in leaves(p, is_leaf)]
    return [params]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of `tree` and the matching nodes of `rest`,
    visited in JAX's leaf order (lists in order, dicts by sorted key; a
    node for which `is_leaf` holds is a leaf) -> a structure like
    `tree`'s. A tensor is a tree of one leaf, so ``tree_map(fn, x)`` is
    ``fn(x)``. (`torch.utils._pytree` is private and orders a dict by
    insertion.)"""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def _rebuild(template, it):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(p, it) for p in template)
    return next(it)


def params_from_jax(tree, device=None):
    """The JAX package's parameters (nested dicts/lists of arrays, numpy or
    jax) as the port's: the same structure of f32 torch tensors."""
    it = iter([torch.as_tensor(np.array(x, dtype=np.float32), device=device)
               for x in leaves(tree)])
    return _rebuild(tree, it)


def _tensor_from_numpy(x, device=None) -> torch.Tensor:
    """A numpy (or jax) array as a tensor of the same dtype; bfloat16, which
    numpy holds as ml_dtypes' type, goes through its 16-bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.as_tensor(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(a.copy()).to(device)


def tree_cache_from_jax(tree, device=None):
    """A JAX tree cache or tree carry (nested dicts and lists of numpy or
    jax arrays: a cache's ``{"q", "scale"}`` leaves, a ring, running sums,
    counters) as the port's: the same structure of tensors, each of its
    array's dtype (int8 codes, f32 scales, bf16 rows, int32 counters)."""
    return tree_map(lambda x: _tensor_from_numpy(x, device), tree)


def ravel(params) -> torch.Tensor:
    """Flat f32 vector of a params structure (or a tensor) in JAX's ravel
    order."""
    if isinstance(params, torch.Tensor):
        return params.reshape(-1).float()
    return torch.cat([torch.as_tensor(x).reshape(-1).float()
                      for x in leaves(params)])


def unravel(flat: torch.Tensor, template):
    """Views of `flat` (..., d) shaped like `template`'s leaves, in JAX's
    order; leading batch dimensions of `flat` are kept on every leaf."""
    if isinstance(template, torch.Tensor):
        return flat.reshape(flat.shape[:-1] + template.shape)
    lead = flat.shape[:-1]
    out, off = [], 0
    for x in leaves(template):
        shape = tuple(torch.as_tensor(x).shape)
        size = int(np.prod(shape, dtype=np.int64))
        out.append(flat[..., off:off + size].reshape(lead + shape))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector of {flat.shape[-1]} values for a "
                         f"template of {off}")
    return _rebuild(template, iter(out))
