"""Optimizers (functional, over parameter structures) and LR schedules — a
port of `repro.optim.optim`.

The paper's server update is plain SGD (w ← w − η·u) with η ∝ √(n/T)
(Theorem a.2); local client steps use SGD-momentum / AdamW. All three are
provided. A parameter structure is nested dicts, lists and tuples of
tensors, walked by `repro_torch.convert.tree_map` in JAX's leaf order; the
step counter is a 0-d int32 tensor on the parameters' device."""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.convert import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params) -> (updates, state)


def _step0(params):
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda t: lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        eta = lr_fn(state["step"])
        upd = tree_map(lambda g: -eta * g, grads)
        return upd, {"step": state["step"] + 1}
    return Optimizer(init, update)


def sgd_momentum(lr, momentum=0.9, nesterov=False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda t: lr)

    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        eta = lr_fn(state["step"])
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: -eta * (momentum * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -eta * m, mu)
        return upd, {"step": state["step"] + 1, "mu": mu}
    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda t: lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        t = state["step"] + 1
        eta = lr_fn(t)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(m_, v_, p):
            step = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
            return (-eta * (step + weight_decay * p.float())).to(p.dtype)
        return (tree_map(upd, m, v, params),
                {"step": t, "m": m, "v": v})
    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def sqrt_nt_schedule(c: float, n: int, T: int):
    """Paper Theorem a.2: η = c·√(n/T), constant over the run."""
    eta = c * (n / T) ** 0.5
    return lambda t: eta


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to `peak` over `warmup` steps, then a cosine decay to
    `floor` at `total`: a 0-d f32 tensor of the step."""
    def fn(t):
        t = torch.as_tensor(t).float()
        warm = peak * t / max(warmup, 1)
        prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(t < warmup, warm, cos)
    return fn
