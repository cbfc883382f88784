"""Rows of every leaf of a model, int8 with one scale a row or f32: what
the plain references keep where the program keeps int8 caches and an int8
history. Plain PyTorch; it imports nothing of the program."""
from __future__ import annotations

import math
from typing import Dict

import torch

INT8_MAX = 127.0


def quant(x):
    """Symmetric int8 of each row of x (rows, numel): the scale
    max(max|x|, 1e-12) / 127 (a true division), codes round(x / scale)
    half to even, clipped to +-127, a NaN quotient coded 0."""
    m = torch.clamp(x.abs().amax(-1), min=1e-12)
    s = m / m.new_full((), INT8_MAX)
    q = torch.round(x / s[:, None])
    q = torch.clamp(torch.where(torch.isnan(q), 0.0, q), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), s


def dequant(q, s):
    return q.float() * s[:, None]


class Rows:
    """`rows` rows of every leaf of `shapes`, int8 with a scale each or
    f32."""

    def __init__(self, rows: int, shapes: Dict[str, tuple], dtype: str,
                 device):
        self.int8 = dtype == "int8"
        if dtype not in ("int8", "float32"):
            raise NotImplementedError(f"rows of {dtype}")
        self.shapes = shapes
        dt = torch.int8 if self.int8 else torch.float32
        self.q = {k: torch.zeros((rows, math.prod(s)), dtype=dt,
                                 device=device) for k, s in shapes.items()}
        self.s = {k: torch.ones((rows,), device=device) for k in shapes}

    def set(self, i: int, tree: Dict[str, torch.Tensor]):
        for k, x in tree.items():
            if self.int8:
                q, s = quant(x.reshape(1, -1).float())
                self.q[k][i] = q[0]
                self.s[k][i] = s[0]
            else:
                self.q[k][i] = x.reshape(-1)

    def get(self, i: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, s in self.shapes.items():
            row = self.q[k][i:i + 1]
            out[k] = (dequant(row, self.s[k][i:i + 1]) if self.int8
                      else row.float()).reshape(s)
        return out
