"""Plain reference of the paper's sampled-staleness AFL server (Fig. 2/3
protocol) with one arrival an event (K = 1), one event at a time, in the
order the paper gives it.

Init: every client's gradient at w0 (its own noise row) seeds the rule's
cache; w1 = w0 - lr * mean_i g_i; the history holds w0 and w1. Event e:
the arriving client is the argmax of log(1/n) + gumbel[e]; its staleness
tau = min(floor(tau_raw[e]), emitted updates so far, tau_max); it trains
on the model tau updates old, read from the history; the rule turns the
gradient into the update u; w <- w - lr * u; the history appends w.

The history keeps `history_dtype` rows (int8: each leaf's row quantized
with one scale, `rows.quant`), so a stale read is what an int8 history
holds. Everything is f32 on the caller's device, in plain PyTorch; it
imports nothing of the program. A mix names its protocol
(``"protocol": "afl_k1"`` -> this module).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from reference.rows import Rows


def run(*, grad: Callable, w0: Dict[str, torch.Tensor], rule, n: int,
        lr: float, tau_max: int, history_dtype: str, gumbels, tau_raw,
        noise_init, noise_ticks, first_grad: List = None):
    """The protocol over len(tau_raw) events. `grad(w, client, noise_row)
    -> (loss, {path: gradient})`. Returns the final model and the
    per-event losses and update norms (host lists). `first_grad`, a list,
    receives the first client's init gradient."""
    if tau_raw.dim() != 1:
        raise NotImplementedError("this protocol takes one arrival an event")
    device = next(iter(w0.values())).device
    shapes = {k: tuple(v.shape) for k, v in w0.items()}
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    rows, losses = [], []
    for i in range(n):
        _, g = grad(w0, i, noise_init[i, 0])
        if first_grad is not None and i == 0:
            first_grad.append({k: v.clone() for k, v in g.items()})
        rows.append(g)
    init = {k: torch.stack([r[k] for r in rows]) for k in shapes}
    del rows
    rule.init(init)
    w = {k: w0[k] - lr_t * init[k].mean(0) for k in shapes}
    del init
    S = tau_max + 1
    hist = Rows(S, shapes, history_dtype, device)
    hist.set(0, w0)
    cursor, emitted = 1, 1
    hist.set(cursor, w)
    log_p = torch.as_tensor(np.log(np.full(n, 1.0 / n)), dtype=torch.float32,
                            device=device)
    unorms = []
    for e in range(tau_raw.shape[0]):
        j = int(torch.argmax(log_p + gumbels[e]))
        tau = min(int(torch.floor(tau_raw[e])), emitted, tau_max)
        loss, g = grad(hist.get((cursor - tau) % S), j, noise_ticks[e, 0, 0])
        u = rule.step(j, g)
        w = {k: w[k] - lr_t * u[k].float() for k in shapes}
        cursor = (cursor + 1) % S
        hist.set(cursor, w)
        emitted += 1
        losses.append(float(loss))
        unorms.append(math.sqrt(sum(float(x.float().square().sum())
                                    for x in u.values())))
    del hist
    return w, losses, unorms
