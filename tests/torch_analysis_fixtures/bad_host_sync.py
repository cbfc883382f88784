# ruff: noqa
"""TRC001 true positives: host syncs inside captured code (a program's
tick, what a torch.cuda.graph block calls, an Aggregator's step)."""
import numpy as np
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


class Aggregator:
    pass


def make_program(n):
    def tick(carry, xs, outs):
        t = carry["t"]
        if t > 3:  # EXPECT[TRC001]
            carry["t"] = t - 1
        while carry["e"] < n:  # EXPECT[TRC001]
            carry["e"] += 1
        lr = float(xs["lr"])  # EXPECT[TRC001]
        k = int(carry["k"])  # EXPECT[TRC001]
        outs["loss"] = carry["w"].sum().item()  # EXPECT[TRC001]
        rows = carry["w"].tolist()  # EXPECT[TRC001]
        on_host = carry["w"].cpu()  # EXPECT[TRC001]
        arr = carry["w"].numpy()  # EXPECT[TRC001]
        copied = np.asarray(carry["w"])  # EXPECT[TRC001]
        idx = torch.nonzero(carry["mask"])  # EXPECT[TRC001]
        sel = torch.masked_select(carry["w"], carry["mask"])  # EXPECT[TRC001]
        ids = carry["ids"].unique()  # EXPECT[TRC001]
        hit = torch.where(carry["mask"])  # EXPECT[TRC001]
        assert carry["w"].isfinite().all()  # EXPECT[TRC001]
        return carry
    return _Program(init=None, tick=tick)


def _inner(x):
    y = torch.relu(x)
    return y.max().item()  # EXPECT[TRC001]


def graph_step(w):
    if bool(w.any()):  # EXPECT[TRC001]
        return _inner(w)
    return w


def capture(w):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graph_step(w)
    return g


class Rule(Aggregator):
    def step(self, state, arr):
        if arr.t % 2 == 0:  # EXPECT[TRC001]
            return state, arr.payload
        return state, arr.payload * 0
