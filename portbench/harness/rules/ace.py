"""ACE (`ACEIncremental`): the running mean ``u`` and the client cache."""
from __future__ import annotations

import torch

from harness.tree import is_cache_leaf, paths


def build(core, mix):
    """The rule as the mix states it, from the program's `core`."""
    return core.ACEIncremental(cache_dtype=mix["cache_dtype"])


def update(state):
    """{path: the update the rule applies now}."""
    return paths(state["u"])


def cache_norms(state):
    """{path: [norm of each client's dequantized cache row]}."""
    out = {}
    for k, c in paths(state["cache"], is_cache_leaf).items():
        rows = c["q"].reshape(c["q"].shape[0], -1)
        scale = c.get("scale")
        out[k] = [float(torch.linalg.vector_norm(
            rows[i].float() * (scale[i] if scale is not None else 1.0),
            dtype=torch.float64)) for i in range(rows.shape[0])]
    return out
