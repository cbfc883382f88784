"""Dirichlet non-IID partitioning (paper §5: Dir(α) label-distribution
shift). Copies of `repro.data.partition`'s functions (plain numpy, the
same split and histograms from the same seed)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Split example indices across clients with per-class Dirichlet weights.

    Lower alpha => more heterogeneous (each client dominated by few classes)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_per_client: List[list] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
        alpha *= 1.5  # re-draw with slightly smoother split if degenerate
    return [np.asarray(sorted(ix), np.int64) for ix in idx_per_client]


def label_histograms(labels: np.ndarray, parts: List[np.ndarray]) -> np.ndarray:
    """(clients, classes) counts of each client's labels."""
    n_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), n_classes))
    for i, ix in enumerate(parts):
        for c, cnt in zip(*np.unique(labels[ix], return_counts=True)):
            out[i, c] = cnt
    return out
