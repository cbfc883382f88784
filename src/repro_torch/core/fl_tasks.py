"""Ready-made FL tasks binding synthetic data + Dirichlet partition + a small
model into (grad_fn, eval_fn, params0) — port of the vision task of
`repro.core.fl_tasks` (the Fig. 2/3 CIFAR-10 stand-in).

The model keeps the JAX layout: ``x @ w + b`` with `w` of shape (in, out),
and a parameter list of ``{"w", "b"}`` dicts raveled in JAX's order
(`repro_torch.convert`). A client gradient is computed for a batch of B
lanes at once — B models, B clients, B noise rows — so the K arrivals of a
tick (and the n clients of the init batch) are one batched call.

Minibatch sampling reads a per-call uniform vector ``u (batch,)`` as
``ix = min(floor(u · n_client), n_client − 1)``; the uniforms are the
payload noise the engine hands to `grad_fn` (drawn by
``grad_fn.sample_noise``), so a test can feed the JAX reference the same
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.convert import unravel
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification
from repro_torch.kernels.backend import resolve_device


def mlp_classifier(dims: Sequence[int]):
    """ReLU MLP over `dims`: ``(init(generator, device) -> params,
    apply(params, x) -> logits)``. `apply` takes leaves with leading batch
    dimensions (B, in, out) / (B, out) against x (B, N, in) as well as plain
    ones."""
    def init(generator: torch.Generator, device=None):
        params = []
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.randn((a, b), generator=generator,
                            device=generator.device) * (2.0 / a) ** 0.5
            params.append({"w": w.to(device),
                           "b": torch.zeros((b,), device=device)})
        return params

    def apply(params, x):
        for i, p in enumerate(params):
            x = torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)
            if i < len(params) - 1:
                x = torch.relu(x)
        return x
    return init, apply


def _xent(logits, y):
    """Mean softmax cross-entropy over the last-but-one axis."""
    logz = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
    return (logz - picked).mean(-1)


def _pad_clients(xs, ys, parts):
    """Pad per-client datasets to a common length; sampling draws indices
    below each client's true count."""
    mx = max(len(ix) for ix in parts)
    cx = np.zeros((len(parts), mx) + xs.shape[1:], xs.dtype)
    cy = np.zeros((len(parts), mx), ys.dtype)
    cn = np.zeros((len(parts),), np.int32)
    for i, ix in enumerate(parts):
        cx[i, :len(ix)] = xs[ix]
        cy[i, :len(ix)] = ys[ix]
        cn[i] = len(ix)
    return cx, cy, cn


@dataclasses.dataclass
class ClientGrad:
    """A batched client gradient with the noise it consumes:
    ``fn(w (B, d), clients (B,), noise (B, *noise_shape)) -> (loss (B,),
    grads (B, d))``, noise drawn as uniform on [0, 1) or standard normal."""
    fn: Callable
    noise_shape: tuple
    noise_dist: str = "uniform"

    def __call__(self, w, clients, noise):
        return self.fn(w, clients, noise)

    def sample_noise(self, lead_shape, generator, device):
        shape = tuple(lead_shape) + tuple(self.noise_shape)
        draw = torch.rand if self.noise_dist == "uniform" else torch.randn
        return draw(shape, generator=generator, device=device)


@dataclasses.dataclass
class FLTask:
    params0: object
    grad_fn: ClientGrad    # batched, see ClientGrad
    eval_fn: Callable      # (params) -> {"accuracy": float}
    n_clients: int
    meta: Dict


def make_vision_task(*, n_clients=100, alpha=0.3, batch=50, n_classes=10,
                     dim=64, hidden=(128, 64), n_train=20000, n_test=4000,
                     noise=0.6, seed=0, device=None) -> FLTask:
    """CIFAR-10 stand-in: Gaussian-mixture classification, Dir(α) partition
    (the same arrays as the JAX package's from the same seed), MLP with
    weights drawn from a generator seeded with `seed`. On the GPU unless
    ``device="cpu"``."""
    device = resolve_device(device)
    x, y = make_classification(n_train + n_test, n_classes, dim, noise=noise,
                               seed=seed)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    parts = dirichlet_partition(ytr, n_clients, alpha, seed=seed + 1)
    init, apply = mlp_classifier((dim,) + tuple(hidden) + (n_classes,))
    params0 = init(torch.Generator().manual_seed(seed), device)
    cx, cy, cn = (torch.as_tensor(a).to(device)
                  for a in _pad_clients(xtr, ytr, parts))
    cy = cy.long()

    def grad(w, clients, u):
        clients = clients.long()
        n_c = cn[clients].unsqueeze(-1)                        # (B, 1)
        ix = torch.minimum(torch.floor(u * n_c.float()).long(), n_c - 1)
        xb = cx[clients.unsqueeze(-1), ix]                     # (B, batch, dim)
        yb = cy[clients.unsqueeze(-1), ix]
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            loss = _xent(apply(unravel(w, params0), xb), yb)   # (B,)
            (g,) = torch.autograd.grad(loss.sum(), w)
        return loss.detach(), g

    xte_t, yte_t = torch.as_tensor(xte).to(device), torch.as_tensor(yte).to(device)

    def eval_fn(params):
        with torch.no_grad():
            pred = torch.argmax(apply(params, xte_t), -1)
            return {"accuracy": float((pred == yte_t).float().mean())}

    return FLTask(params0, ClientGrad(grad, (batch,)), eval_fn, n_clients,
                  {"alpha": alpha, "kind": "vision"})
