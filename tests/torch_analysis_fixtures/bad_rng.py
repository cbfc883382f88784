# ruff: noqa
"""TRC002 true positives: draws off the caller's generator in library code,
and any draw inside captured code."""
import random

import numpy as np
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


def init_weights(shape):
    w = torch.randn(shape)  # EXPECT[TRC002]
    b = torch.rand(shape[-1])  # EXPECT[TRC002]
    return w, b


def sample_clients(probs, k):
    return torch.multinomial(probs, k)  # EXPECT[TRC002]


def payload_noise(x):
    return x.clone().uniform_(-1, 1)  # EXPECT[TRC002]


def staleness(n):
    return torch.empty(n).exponential_()  # EXPECT[TRC002]


def make_program(gen):
    def tick(carry, xs, outs):
        g = torch.randn(carry["w"].shape, generator=gen)  # EXPECT[TRC002]
        u = np.random.rand()  # EXPECT[TRC002]
        v = random.random()  # EXPECT[TRC002]
        carry["w"] = carry["w"] + g * u * v
        return carry
    return _Program(init=None, tick=tick)
