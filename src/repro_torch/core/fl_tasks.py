"""Ready-made FL tasks binding synthetic data + Dirichlet partition + a small
model into (grad_fn, eval_fn, params0) — port of the vision, text and LM
tasks of `repro.core.fl_tasks` (the Fig. 2/3 CIFAR-10 stand-in, the Table
a.2 20 Newsgroups stand-in, and a transformer of `repro_torch.models` on
the synthetic token stream).

The models keep the JAX layout: ``x @ w + b`` with `w` of shape (in, out),
and parameters raveled in JAX's order (`repro_torch.convert`: the MLP's
list of ``{"w", "b"}`` dicts, the text model's dict by sorted key). A
client gradient is computed for a batch of B lanes at once — B models, B
clients, B noise rows — so the K arrivals of a tick (and the n clients of
the init batch) are one batched call.

Minibatch sampling reads a per-call uniform vector ``u (batch,)`` as
``ix = min(floor(u · n_client), n_client − 1)`` (the LM task: window
starts, `make_lm_task`); the uniforms are the payload noise the engine
hands to `grad_fn` (drawn by ``grad_fn.sample_noise``), so a test can feed
the JAX reference the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import _rebuild, leaves, unravel
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (make_classification,
                                        make_text_classification,
                                        make_token_stream)
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
                            dtype=torch.float32,
                            device=generator.device) * (2.0 / a) ** 0.5
            params.append({"w": w.to(device),
                           "b": torch.zeros((b,), dtype=torch.float32,
                                            device=device)})
        return params

    def apply(params, x):
        for i, p in enumerate(params):
            x = torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)
            if i < len(params) - 1:
                x = torch.relu(x)
        return x
    return init, apply


def tiny_text_classifier(vocab: int, d: int, n_classes: int, seq_len: int):
    """Embedding + mean-pool + 2-layer head (the BERT-experiment stand-in):
    ``(init(generator, device) -> params, apply(params, toks) -> logits)``.
    `apply` takes plain leaves against toks (N, seq_len) and leaves with a
    leading lane axis B (emb (B, vocab, d), ...) against toks (B, N,
    seq_len). The B tables are gathered as one flat (B·vocab, d) table at
    lane-offset indices through `F.embedding`, whose backward sums each
    row's gradient without the scattered atomic adds that indexing
    ``emb[b, toks]`` would put in it."""
    def init(generator: torch.Generator, device=None):
        def normal(shape, std):
            return (torch.randn(shape, generator=generator,
                                dtype=torch.float32,
                                device=generator.device) * std).to(device)
        return {"emb": normal((vocab, d), 0.05),
                "w1": normal((d, d), (2.0 / d) ** 0.5),
                "b1": torch.zeros((d,), dtype=torch.float32,
                                  device=device),
                "w2": normal((d, n_classes), (1.0 / d) ** 0.5),
                "b2": torch.zeros((n_classes,), dtype=torch.float32,
                                  device=device)}

    def apply(params, toks):
        emb = params["emb"]
        if emb.dim() == 3:
            lanes = emb.shape[0]
            offset = torch.arange(lanes, dtype=torch.int64,
                                  device=toks.device) * vocab
            toks = toks + offset.reshape((lanes,) + (1,) * (toks.dim() - 1))
            emb = emb.reshape(lanes * vocab, d)
        h = F.embedding(toks, emb).mean(-2)
        h = torch.relu(torch.matmul(h, params["w1"])
                       + params["b1"].unsqueeze(-2))
        return torch.matmul(h, params["w2"]) + params["b2"].unsqueeze(-2)
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
    ``fn(w, clients (B,), noise (B, *noise_shape)) -> (loss (B,), grads)``
    where `w` is a (B, d) tensor of raveled models (the flat layout) or a
    parameter structure whose leaves lead with (B,) (the tree layout), and
    `grads` has `w`'s form; noise drawn as uniform on [0, 1) or standard
    normal."""
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


def _task(x, y, n_train, n_clients, alpha, seed, init, apply, batch, device,
          meta) -> FLTask:
    """The task around a model: the first `n_train` examples split over the
    clients by Dir(α) (seed + 1), the rest the test set, weights drawn from
    a generator seeded with `seed`, the batched client gradient and the
    test accuracy."""
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    parts = dirichlet_partition(ytr, n_clients, alpha, seed=seed + 1)
    params0 = init(torch.Generator().manual_seed(seed), device)
    cx, cy, cn = (torch.as_tensor(a).to(device)
                  for a in _pad_clients(xtr, ytr, parts))
    if not cx.is_floating_point():           # token ids index the embedding
        cx = cx.long()
    cy = cy.long()

    def grad(w, clients, u):
        clients = clients.long()
        n_c = cn[clients].unsqueeze(-1)                        # (B, 1)
        ix = torch.minimum(torch.floor(u * n_c.float()).long(), n_c - 1)
        xb = cx[clients.unsqueeze(-1), ix]                     # (B, batch, ...)
        yb = cy[clients.unsqueeze(-1), ix]
        flat = isinstance(w, torch.Tensor)
        with torch.enable_grad():
            # the raveled (B, d) rows, or the parameter structure itself
            # (the tree layout): its leaves are the leaves of the gradient
            xs = [x.detach().requires_grad_(True)
                  for x in ([w] if flat else leaves(w))]
            params = (unravel(xs[0], params0) if flat
                      else _rebuild(w, iter(xs)))
            loss = _xent(apply(params, xb), yb)                # (B,)
            gs = torch.autograd.grad(loss.sum(), xs)
        return loss.detach(), gs[0] if flat else _rebuild(w, iter(gs))

    xte_t = torch.as_tensor(xte).to(device)
    if not xte_t.is_floating_point():
        xte_t = xte_t.long()
    yte_t = torch.as_tensor(yte).to(device)

    def eval_fn(params):
        with torch.no_grad():
            pred = torch.argmax(apply(params, xte_t), -1)
            return {"accuracy": float((pred == yte_t).float().mean())}

    return FLTask(params0, ClientGrad(grad, (batch,)), eval_fn, n_clients,
                  meta)


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
    init, apply = mlp_classifier((dim,) + tuple(hidden) + (n_classes,))
    return _task(x, y, n_train, n_clients, alpha, seed, init, apply, batch,
                 device, {"alpha": alpha, "kind": "vision"})


def make_text_task(*, n_clients=20, alpha=1.0, batch=32, n_classes=20,
                   vocab=1024, d=64, seq_len=64, n_train=6000, n_test=2000,
                   seed=0, device=None) -> FLTask:
    """20 Newsgroups stand-in for the DistilBERT/BERT table (a.2): token
    sequences whose class sets the token distribution, Dir(α) partition
    (the same arrays as the JAX package's from the same seed), embedding +
    mean-pool + 2-layer head with weights drawn from a generator seeded
    with `seed` (d = 70,996 at the defaults). On the GPU unless
    ``device="cpu"``."""
    device = resolve_device(device)
    x, y = make_text_classification(n_train + n_test, n_classes, seq_len,
                                    vocab, seed=seed)
    init, apply = tiny_text_classifier(vocab, d, n_classes, seq_len)
    return _task(x, y, n_train, n_clients, alpha, seed, init, apply, batch,
                 device, {"alpha": alpha, "kind": "text"})


def make_lm_task(*, cfg, n_clients=8, batch=8, seq=256, n_tokens=1 << 18,
                 seed=0, device=None) -> FLTask:
    """Real-model LM task: a transformer of `repro_torch.models` (built from
    `cfg`) on the synthetic Markov token stream — the port of
    `repro.core.fl_tasks.make_lm_task`, for the tree layout.

    Client i samples `batch` windows of ``seq + 1`` tokens from its
    contiguous region of the stream (``per = n_tokens // n_clients``
    tokens; a distinct local distribution, since the stream's hash state
    drifts); the stream lives on the device. A lane's noise is ``(batch,)``
    uniforms, its window starts ``lo + min(floor(u · (per − seq − 1)),
    per − seq − 2)`` (the port's rule in place of JAX's
    ``jax.random.randint``, as the vision task's minibatch rule).

    `grad_fn` takes the tree layout (leaves leading with (B,)) or the flat
    layout ((B, d) rows, `unravel`) and runs its B lanes one after another
    — `model.loss_fn` on lane b's parameters, its gradient written into
    preallocated ``(B, *leaf)`` buffers — so only one lane's activations
    are ever live and no stacked copy of the lanes is made. `eval_fn`
    reports the LM loss on the fixed batch JAX draws
    (``np.random.default_rng(seed + 7)``). Weights come from
    ``model.init`` on a generator seeded with `seed` on the task's device.
    On the GPU unless ``device="cpu"``."""
    from repro_torch.models import build_model

    device = resolve_device(device)
    model = build_model(cfg)
    params0 = model.init(torch.Generator(device=device).manual_seed(seed))
    toks = make_token_stream(n_tokens=n_tokens, vocab=cfg.vocab_size,
                             seed=seed)
    per = len(toks) // n_clients
    if per < seq + 2:
        raise ValueError(f"stream too short: {per} tokens/client < seq+2")
    toks_t = torch.as_tensor(toks).to(device=device, dtype=torch.int64)
    offsets = torch.arange(seq + 1, dtype=torch.int64, device=device)

    def grad(w, clients, u):
        lo = clients.long().unsqueeze(-1) * per                 # (B, 1)
        starts = lo + torch.clamp(
            torch.floor(u * float(per - seq - 1)).long(), max=per - seq - 2)
        window = toks_t[starts.unsqueeze(-1) + offsets]     # (B, batch, seq+1)
        flat = isinstance(w, torch.Tensor)
        xs = [w] if flat else leaves(w)
        lanes = xs[0].shape[0]
        gs = [torch.empty_like(x) for x in xs]
        loss = torch.empty((lanes,), dtype=torch.float32,
                           device=xs[0].device)
        for b in range(lanes):
            lane = [x[b].detach().requires_grad_(True) for x in xs]
            params = (unravel(lane[0], params0) if flat
                      else _rebuild(w, iter(lane)))
            lane_batch = {"tokens": window[b, :, :-1],
                          "targets": window[b, :, 1:]}
            with torch.enable_grad():
                lb = model.loss_fn(params, lane_batch)
                for g_out, g in zip(gs, torch.autograd.grad(lb, lane)):
                    g_out[b].copy_(g)
            loss[b] = lb.detach()
        return loss, gs[0] if flat else _rebuild(w, iter(gs))

    erng = np.random.default_rng(seed + 7)
    estarts = erng.integers(0, len(toks) - seq - 1, size=batch)
    eval_batch = {
        "tokens": torch.as_tensor(np.stack(
            [toks[s:s + seq] for s in estarts])).to(device),
        "targets": torch.as_tensor(np.stack(
            [toks[s + 1:s + seq + 1] for s in estarts])).to(device)}

    def eval_fn(params):
        with torch.no_grad():
            return {"loss": float(model.loss_fn(params, eval_batch))}

    return FLTask(params0, ClientGrad(grad, (batch,)), eval_fn, n_clients,
                  {"kind": "lm", "model": cfg.name,
                   "params": int(cfg.param_count())})
