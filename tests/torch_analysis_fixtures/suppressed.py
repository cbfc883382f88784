# ruff: noqa
"""Inline suppression: acknowledged findings silenced with an ignore tag."""
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


def make_program():
    def tick(carry, xs, outs):
        lr = float(xs["lr"])  # tracecheck: ignore[TRC001]
        carry["w"] = carry["w"] * lr
        return carry
    return _Program(init=None, tick=tick)


def debug_weights(shape):
    return torch.randn(shape)  # tracecheck: ignore[TRC002]
