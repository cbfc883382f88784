"""Deterministic synthetic datasets — the offline stand-in for CIFAR-10.

A copy of `repro.data.synthetic.make_classification` (plain numpy, same
arrays from the same seed): a K-class mixture of Gaussians with
class-dependent means on a hypersphere plus per-class low-rank structure.
Heterogeneity comes from Dirichlet label partitioning
(`repro_torch.data.partition`), matching the paper's non-IID protocol.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(n: int = 10000, n_classes: int = 10, dim: int = 64,
                        noise: float = 0.6, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    means *= 2.5
    basis = rng.normal(size=(n_classes, dim, 4)) * 0.5
    y = rng.integers(0, n_classes, size=n)
    z = rng.normal(size=(n, 4))
    x = means[y] + np.einsum("ndk,nk->nd", basis[y], z) + \
        rng.normal(size=(n, dim)) * noise
    return x.astype(np.float32), y.astype(np.int32)
