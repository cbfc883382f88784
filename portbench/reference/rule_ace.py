"""ACE, the paper's Algorithm a.5: the server keeps every client's latest
gradient in a cache and applies their mean, u = (1/n) sum_i C_i, kept
incrementally: on client j's arrival u <- u + (dq(C_j') - dq(C_j)) / n,
so with an int8 cache u stays the mean of the dequantized rows."""
from __future__ import annotations

from typing import Dict

import torch

from reference.rows import Rows


class Rule:
    def __init__(self, n: int, cache_dtype: str):
        self.n, self.cache_dtype = n, cache_dtype

    def init(self, rows: Dict[str, torch.Tensor]):
        """rows: {path: (n, *shape)} the init batch's gradients."""
        shapes = {k: tuple(v.shape[1:]) for k, v in rows.items()}
        dev = next(iter(rows.values())).device
        self.cache = Rows(self.n, shapes, self.cache_dtype, dev)
        for i in range(self.n):
            self.cache.set(i, {k: v[i] for k, v in rows.items()})
        mean = None
        for i in range(self.n):
            row = self.cache.get(i)
            mean = row if mean is None else {k: mean[k] + row[k]
                                             for k in row}
        self.u = {k: v / self.n for k, v in mean.items()}

    def step(self, j: int, g: Dict[str, torch.Tensor]):
        old = self.cache.get(j)
        self.cache.set(j, g)
        new = self.cache.get(j)
        self.u = {k: self.u[k] + (new[k] - old[k]) / self.n for k in g}
        return self.u

    def update(self) -> Dict[str, torch.Tensor]:
        """The update the rule would apply now, u."""
        return self.u

    def cache_norms(self) -> Dict[str, list]:
        """The norm of each client's dequantized cache row, by path."""
        out = {k: [] for k in self.cache.shapes}
        for i in range(self.n):
            for k, x in self.cache.get(i).items():
                out[k].append(float(torch.linalg.vector_norm(
                    x, dtype=torch.float64)))
        return out
