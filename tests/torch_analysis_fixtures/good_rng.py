# ruff: noqa
"""Clean twins of bad_rng: every draw from a caller-seeded generator, drawn
before the tick, which only reads the streams."""
import numpy as np
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


def init_weights(shape, generator):
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    b = torch.rand(shape[-1], generator=generator, dtype=torch.float32)
    return w, b


def sample_clients(probs, k, generator):
    return torch.multinomial(probs, k, generator=generator)


def staleness(n, generator):
    return torch.empty(n, dtype=torch.float32).exponential_(
        generator=generator)


def build_streams(seed, n_events, d):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    host = np.random.default_rng(seed)      # host draws: not torch's
    return torch.randn((n_events, d), generator=gen), host.integers(0, 9)


def make_program():
    def tick(carry, xs, outs):
        e = carry["e"].reshape(1)
        g = xs["noise"].index_select(0, e)[0]     # read, not drawn
        carry["w"] = carry["w"] + g
        carry["e"] += 1
        return carry
    return _Program(init=None, tick=tick)
