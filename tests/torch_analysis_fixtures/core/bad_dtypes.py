# ruff: noqa
"""TRC003 true positives: buffers built in core/ without a dtype, and a
beyond-f32 literal in captured arithmetic."""
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


def make_buffers(n, device):
    hist = torch.zeros((n, 4), device=device)  # EXPECT[TRC003]
    mask = torch.ones((n,), device=device)  # EXPECT[TRC003]
    owner = torch.full((n,), -1, device=device)  # EXPECT[TRC003]
    scratch = torch.empty((n, 4), device=device)  # EXPECT[TRC003]
    idx = torch.arange(n, device=device)  # EXPECT[TRC003]
    coef = torch.tensor([1.0, 0.5], device=device)  # EXPECT[TRC003]
    return hist, mask, owner, scratch, idx, coef


def make_program():
    def tick(carry, xs, outs):
        carry["w"] = carry["w"] * 3.141592653589793  # EXPECT[TRC003]
        return carry
    return _Program(init=None, tick=tick)
