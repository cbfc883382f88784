"""Carrying parameters between the JAX package and the port.

The JAX engines ravel a parameter pytree with `ravel_pytree`, whose order is
the pytree's leaf order: lists and tuples in order, dicts by sorted key. For
the MLP's list of ``{"w", "b"}`` dicts that is, per layer, **b first, then
w**, each row-major. `ravel`/`unravel` keep that order, so both packages
compute on the same flat vector `w`.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def leaves(params) -> List[Any]:
    """The leaves of a params structure in JAX's flattening order."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for p in params for x in leaves(p)]
    return [params]


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
