"""The LM task (`make_lm_task`): each client's gradient a forward and
backward pass of the configuration's model over windows of its own region
of the synthetic token stream."""
from __future__ import annotations

import torch

from harness import flops
from harness.inputs import TOKENS, sub_seed
from harness.port import model_config
from harness.tree import paths


def build(port, cfg: dict, mix: dict, seed: int, weights: dict, device):
    """The program's task at the mix's sizes, its token stream from the
    run's seed, its parameters overwritten with the benchmark's `weights`
    (by path; the program's own structure has to hold exactly these)."""
    task = port.core.make_lm_task(
        cfg=model_config(port, cfg), n_clients=mix["n_clients"],
        batch=mix["batch"], seq=mix["seq"], n_tokens=mix["n_tokens"],
        seed=sub_seed(seed, TOKENS), device=device)
    mine = paths(task.params0)
    got = {k: tuple(v.shape) for k, v in mine.items()}
    want = {k: tuple(v.shape) for k, v in weights.items()}
    if got != want:
        raise RuntimeError(f"the program's parameters {sorted(got.items())} "
                           f"are not the configuration's "
                           f"{sorted(want.items())}")
    with torch.no_grad():
        for k, x in mine.items():
            x.copy_(weights[k])
    return task


def gradient_flops(cfg: dict, mix: dict) -> float:
    """One client gradient's operations: a batch of the mix's windows."""
    return flops.gradient_flops(cfg, mix["batch"], mix["seq"])
