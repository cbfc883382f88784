# ruff: noqa
"""Clean twins of bad_dtypes: dtypes pinned, literals f32-exact."""
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


def make_buffers(n, device, like):
    hist = torch.zeros((n, 4), dtype=torch.float32, device=device)
    mask = torch.ones((n,), dtype=torch.bool, device=device)
    owner = torch.full((n,), -1, dtype=torch.int32, device=device)
    scratch = torch.empty((n, 4), dtype=torch.float32, device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    coef = torch.tensor([1.0, 0.5], dtype=torch.float32, device=device)
    same = torch.zeros_like(like)           # inherits like's dtype
    return hist, mask, owner, scratch, idx, coef, same


def make_program():
    def tick(carry, xs, outs):
        carry["w"] = carry["w"] * 0.25
        return carry
    return _Program(init=None, tick=tick)
