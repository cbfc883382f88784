"""Everything a run feeds the program and the reference, made from the
run's seed: the weights, the protocol's random streams and the payload
noise, and the seeds the program's own set-up takes (the token stream).

The same seed gives the same inputs on every call, on the card in a few
large draws from `torch.Generator`s of the run's device. Each input has a
stream of its own (`sub_seed`), so adding an input never moves another.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np
import torch

#: the streams of a run, one generator each
WEIGHTS, PROTOCOL, NOISE, TOKENS, QUANT = range(5)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of `stream` derived from the run's `seed` (any
    non-negative whole number)."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def _rule(path: str, rules) -> Dict:
    for rule in rules:
        if re.fullmatch(rule["match"], path):
            return rule
    raise KeyError(f"no init rule of the configuration matches {path!r}")


def make_weights(shapes: Dict[str, Tuple[int, ...]], rules, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """f32 weights by path: every "normal" leaf from one draw of the
    weights' generator (in path order), scaled by its rule's std (a number,
    or "fan_in": 1/sqrt(shape[-2])); "const" and "log_linspace" (along the
    last axis) leaves filled by rule."""
    paths = sorted(shapes)
    normal = [p for p in paths if "normal" in _rule(p, rules)]
    total = sum(math.prod(shapes[p]) for p in normal)
    draw = torch.randn((total,), generator=generator(seed, WEIGHTS, device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for p in paths:
        rule, shape = _rule(p, rules), shapes[p]
        if "normal" in rule:
            n = math.prod(shape)
            std = rule["normal"]
            std = 1.0 / math.sqrt(shape[-2]) if std == "fan_in" else float(std)
            out[p] = (draw[at:at + n] * std).reshape(shape)
            at += n
        elif "const" in rule:
            out[p] = torch.full(shape, float(rule["const"]),
                                dtype=torch.float32, device=device)
        elif "log_linspace" in rule:
            lo, hi = rule["log_linspace"]
            row = torch.log(torch.linspace(float(lo), float(hi), shape[-1],
                                           dtype=torch.float32,
                                           device=device))
            out[p] = row.expand(shape).contiguous()
        else:
            raise ValueError(f"init rule {rule} of {p!r}: normal, const or "
                             "log_linspace")
    del draw
    return out


class Streams:
    """The protocol's draws for `events` events of `n` clients at K lanes
    and the payload noise (uniforms, one row of `batch` a lane, one row a
    client for the init batch)."""

    def __init__(self, seed: int, events: int, n: int, k: int, beta: float,
                 batch: int, device):
        g = generator(seed, PROTOCOL, device)

        def exp1(shape):
            return torch.empty(shape, dtype=torch.float32,
                               device=device).exponential_(generator=g)
        self.gumbels = -torch.log(exp1((events, n)))
        self.tau_raw = exp1((events,) if k == 1 else (events, k)) * beta
        g = generator(seed, NOISE, device)
        self.noise_init = torch.rand((n, 1, batch), generator=g,
                                     device=device)
        self.noise_ticks = torch.rand((events, k, 1, batch), generator=g,
                                      device=device)


def lr_of(mix) -> float:
    """The server lr the mix states: the paper's sqrt(n/T) schedule."""
    lr = mix["lr"]
    if lr["schedule"] != "sqrt_nt":
        raise ValueError(f"lr schedule {lr['schedule']!r}")
    return float(lr["c"]) * math.sqrt(mix["n_clients"] / mix["T"])
