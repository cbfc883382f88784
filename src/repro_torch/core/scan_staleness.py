"""Sampled-staleness engine on the flat (n, d) cache — port of the flat
layout of `repro.core.scan_staleness` (the paper's Fig. 2/3 protocol).

Per tick: sample the arriving client(s) by Gumbel argmax (K = 1) or
Gumbel top-k (K > 1) over speed-skewed log-probabilities with the
availability windows folded in, draw each lane's staleness τ from Exp(β),
read the stale model from a ``(tau_max+1, d)`` ring of recent models,
compute the client payload(s), run the aggregator's `step` /
`step_batch`, and apply the emitted update. When every client is inside its
window the protocol freezes: the tick holds model and aggregator state and
fast-forwards t to the earliest rejoin.

The JAX package scans this on the device; here it is a Python loop over
ticks whose body only enqueues work on the device: ``t``, the update count,
``emit`` and the freeze/thaw stay tensors, and nothing is read on the host
until the run ends. The cache is updated in place; a frozen tick restores
the rows it wrote.

Randomness. Everything the protocol draws is independent of model values,
so it is made up front: the per-tick gumbel rows, the per-lane ``tau_raw``
(`StalenessRandomness`) and the per-(tick, lane) payload noise plus one
noise row per client for the init batch (`PayloadNoise`). The port draws
them from a `torch.Generator` seeded with ``seed``
(`build_staleness_randomness`, `build_payload_noise`); a caller may pass its
own (the tests replay the JAX package's streams through ``randomness=`` and
``payload_noise=``). `jax.random` is never reproduced.

Not ported yet: eval marks, fault schedules and guards, resync, checkify,
the tree layout, seeds/grids and the chunked runner.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.convert import ravel
from repro_torch.core.aggregators import (Aggregator, Arrival, ArrivalBatch,
                                          wants_cache_init)
from repro_torch.core.cache import FlatCache
from repro_torch.core.scan_engine import (ScanResult, _payload_chain,
                                          _to_result, default_n_events)
from repro_torch.core.staleness_sim import (NEVER, default_tau_max,
                                            staleness_client_probs)
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class StalenessRandomness:
    """Per-event randomness of one run that does not depend on model
    values (the JAX package's record, as tensors)."""
    gumbels: torch.Tensor    # (n_events, n) f32 — categorical sampling noise
    tau_raw: torch.Tensor    # (n_events,) f32 Exp(β) staleness, pre-cap;
    #                          (n_events, k_batch) with k_batch > 1
    leave_at: torch.Tensor   # (n,) int32 — iteration a client leaves (NEVER: stays)
    rejoin_at: torch.Tensor  # (n,) int32 — iteration it comes back (NEVER: permanent)

    @property
    def n_events(self) -> int:
        return self.tau_raw.shape[0]

    def to(self, device) -> "StalenessRandomness":
        return StalenessRandomness(
            *(torch.as_tensor(x).to(device) for x in
              (self.gumbels, self.tau_raw, self.leave_at, self.rejoin_at)))


@dataclasses.dataclass
class PayloadNoise:
    """The noise every client payload consumes, per local step: one row per
    client for the init batch and one per (tick, lane)."""
    init: torch.Tensor       # (n, local_steps, *noise_shape)
    ticks: torch.Tensor      # (n_events, k_batch, local_steps, *noise_shape)

    def to(self, device) -> "PayloadNoise":
        return PayloadNoise(torch.as_tensor(self.init).to(device),
                            torch.as_tensor(self.ticks).to(device))


def build_staleness_randomness(seed: int, n_events: int, n_clients: int,
                               beta: float, dropout_frac: float = 0.0,
                               speed_skew: float = 0.0,
                               dropout_at: Optional[int] = None,
                               rejoin_at: Optional[int] = None,
                               windows=None, k_batch: int = 1,
                               device=None) -> StalenessRandomness:
    """Draw the protocol's random stream on `device` from a generator
    seeded with `seed`: gumbels as ``−log(Exp(1))``, ``tau_raw`` as
    ``β·Exp(1)`` (one per lane per tick when ``k_batch > 1``). Availability
    comes from ``windows = (leave_at, rejoin_at)``, else from
    ``dropout_frac``/``dropout_at`` (+ optional ``rejoin_at``: the dropout
    set is drawn without replacement with the participation
    probabilities), else every client is always on."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def exp1(shape):
        return torch.empty(shape, dtype=torch.float32,
                           device=device).exponential_(generator=gen)

    gumbels = -torch.log(exp1((n_events, n_clients)))
    tau_shape = (n_events,) if k_batch == 1 else (n_events, int(k_batch))
    tau_raw = exp1(tau_shape) * beta
    if windows is not None:
        leave, rejoin = (torch.as_tensor(np.asarray(x), dtype=torch.int32)
                         .to(device) for x in windows)
        return StalenessRandomness(gumbels, tau_raw, leave, rejoin)
    leave = torch.full((n_clients,), NEVER, dtype=torch.int32, device=device)
    rejoin = torch.full((n_clients,), NEVER, dtype=torch.int32, device=device)
    k = int(dropout_frac * n_clients)
    if k > 0 and dropout_at is not None:
        probs = torch.as_tensor(staleness_client_probs(n_clients, speed_skew),
                                dtype=torch.float32).to(device)
        idx = torch.multinomial(probs, k, replacement=False, generator=gen)
        leave[idx] = dropout_at
        if rejoin_at is not None:
            rejoin[idx] = rejoin_at
    return StalenessRandomness(gumbels, tau_raw, leave, rejoin)


def build_payload_noise(grad_fn, seed: int, n_events: int, n_clients: int,
                        k_batch: int = 1, local_steps: int = 1,
                        device=None) -> PayloadNoise:
    """Draw the payload noise of a run with ``grad_fn.sample_noise`` from a
    generator seeded with `seed` (a stream of its own, apart from
    `build_staleness_randomness`'s)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed + 0x5EED)
    init = grad_fn.sample_noise((n_clients, local_steps), gen, device)
    ticks = grad_fn.sample_noise((n_events, k_batch, local_steps), gen,
                                 device)
    return PayloadNoise(init, ticks)


# ---------------------------------------------------------------------------
# Ring-buffer model history: the bounded deque, on the device.
# ---------------------------------------------------------------------------

def ring_read(ring: torch.Tensor, cursor, tau):
    """``history[-(tau+1)]``: the model τ emitted updates ago (one row for a
    0-d τ, (K, d) rows for a (K,) τ). `cursor` is the slot holding the
    newest model; requires τ ≤ min(t, capacity−1)."""
    slot = torch.remainder(cursor - tau, ring.shape[0]).long()
    return ring.index_select(0, slot.reshape(-1)).reshape(
        tuple(slot.shape) + ring.shape[1:])


def ring_append(ring: torch.Tensor, cursor, w, emit):
    """``history.append(w)`` gated on `emit`, in place: advance the cursor
    and write. When not emitting the cursor stays and `w` (unchanged)
    rewrites its own slot, so the write is unconditional."""
    cursor = torch.where(emit, torch.remainder(cursor + 1, ring.shape[0]),
                         cursor)
    ring.index_copy_(0, cursor.long().reshape(1), w[None])
    return ring, cursor


def _select_state(proc, new, old, saved, idx):
    """``where(proc, new, old)`` over the aggregator state. The tensors of
    `old` were never written (the rules replace them), so a select is
    enough; a cache in `saved` was written in place at rows `idx`, so a tick
    that did not process restores those rows from it. A cache not in
    `saved` is taken as it stands."""
    out = {}
    for k, v in new.items():
        if isinstance(v, FlatCache) and k not in saved:
            out[k] = v
        elif isinstance(v, FlatCache):
            data, scale = saved[k]
            v.data.index_copy_(0, idx, torch.where(
                proc, v.data.index_select(0, idx), data))
            v.scale.index_copy_(0, idx, torch.where(
                proc, v.scale.index_select(0, idx), scale))
            out[k] = v
        else:
            out[k] = torch.where(proc, v, old[k])
    return out


def run_staleness_scan(*, grad_fn: Callable, params0, aggregator: Aggregator,
                       n_clients: int, server_lr, T: int, beta: float = 5.0,
                       tau_max: Optional[int] = None, speed_skew: float = 0.0,
                       dropout_frac: float = 0.0,
                       dropout_at: Optional[int] = None,
                       rejoin_at: Optional[int] = None, windows=None,
                       n_events: Optional[int] = None, local_steps: int = 1,
                       local_lr: float = 0.05, init_cache_grads: bool = True,
                       seed: int = 0, record_w: bool = False,
                       k_batch: int = 1, device=None,
                       randomness: Optional[StalenessRandomness] = None,
                       payload_noise: Optional[PayloadNoise] = None
                       ) -> ScanResult:
    """One run of the sampled-staleness protocol on the flat cache.

    `grad_fn(w (B, d), clients (B,), noise (B, ...)) -> (loss (B,),
    grads (B, d))` computes B client gradients at B models; it also offers
    ``sample_noise(lead_shape, generator, device)`` for the noise it
    consumes (see `repro_torch.core.fl_tasks.ClientGrad`). `params0` is the
    initial model, a flat tensor or a parameter structure raveled in the
    JAX package's order (`repro_torch.convert.ravel`). `server_lr` is a
    float or a callable of the 0-d int32 iteration tensor.

    The run is on the GPU unless ``device="cpu"``; with no GPU and no CPU
    request it raises. ``randomness`` / ``payload_noise`` replace the
    streams drawn from `seed` (the event count is then theirs).
    ``k_batch > 1`` consumes K arrivals per tick through `step_batch` (the
    direct rules have none and raise `NotImplementedError`, as in the JAX
    package)."""
    device = resolve_device(device)
    # the client gradients are compared with the JAX package's in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, K, agg = n_clients, int(k_batch), aggregator
    if not 1 <= K <= n:
        raise ValueError(f"k_batch={K} must be in [1, n_clients={n}]")
    mc = getattr(agg, "max_cohort", None)
    if K > 1 and mc is not None and mc < K:
        raise ValueError(f"{type(agg).__name__}(max_cohort={mc}) cannot own "
                         f"k_batch={K} cohorts")
    if randomness is not None:
        n_events = randomness.n_events
    elif n_events is None:
        slack = n if (rejoin_at is not None or windows is not None) else 0
        n_events = default_n_events(agg, T, init_cache_grads) + slack
    E = n_events
    if randomness is None:
        randomness = build_staleness_randomness(
            seed, E, n, beta, dropout_frac, speed_skew, dropout_at=dropout_at,
            rejoin_at=rejoin_at, windows=windows, k_batch=K, device=device)
    if payload_noise is None:
        payload_noise = build_payload_noise(grad_fn, seed, E, n, K,
                                            local_steps, device)
    rand, noise = randomness.to(device), payload_noise.to(device)
    if rand.tau_raw.shape != ((E,) if K == 1 else (E, K)):
        raise ValueError(f"tau_raw of shape {tuple(rand.tau_raw.shape)} for "
                         f"k_batch={K}")
    if tuple(noise.ticks.shape[:3]) != (E, K, local_steps):
        raise ValueError(f"payload noise ticks of shape "
                         f"{tuple(noise.ticks.shape)} for {E} events, "
                         f"k_batch={K}, local_steps={local_steps}")

    tau_max = tau_max if tau_max is not None else default_tau_max(beta)
    S = tau_max + 1
    wants_init = init_cache_grads and wants_cache_init(agg)
    log_probs = torch.as_tensor(np.log(staleness_client_probs(n, speed_skew)),
                                dtype=torch.float32).to(device)
    lr = torch.full((), 0.0 if callable(server_lr) else float(server_lr),
                    dtype=torch.float32, device=device)
    lr_of_t = server_lr if callable(server_lr) else (lambda t: lr)
    payload_fn = _payload_chain(grad_fn, local_steps, local_lr)
    w0 = ravel(params0).to(device=device, dtype=torch.float32)
    d = w0.numel()

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    # init batch: one payload per client at w0 (paper Alg. 1 line 1), and
    # u⁰ applied before the loop (lines 4-5)
    w = w0
    if wants_init:
        clients = torch.arange(n, device=device)
        init_rows, _ = payload_fn(w0[None].repeat(n, 1), clients, noise.init)
        state = agg.init_state(n, d, init_rows, device)
        w = w0 - lr_of_t(i32(0)) * init_rows.mean(0)
        t0 = 1
    else:
        state = agg.init_state(n, d, None, device)
        t0 = 0
    ring = torch.zeros((S, d), dtype=torch.float32, device=device)
    ring[0] = w0
    cursor = i32(0)
    if wants_init:                   # history = [w⁰, w¹] after the init update
        ring, cursor = ring_append(ring, cursor, w,
                                   torch.ones((), dtype=torch.bool,
                                              device=device))
    t, n_upd = i32(t0), i32(t0)
    cache_keys = [k for k, v in state.items() if isinstance(v, FlatCache)]

    outs = {"loss": torch.zeros((E,), device=device),
            "emit": torch.zeros((E,), dtype=torch.bool, device=device),
            "t": torch.zeros((E,), dtype=torch.int32, device=device),
            "unorm": torch.zeros((E,), device=device),
            "alive": torch.zeros((E,), dtype=torch.bool, device=device)}
    if record_w:
        outs["w"] = torch.zeros((E, d), device=device)

    for e in range(E):
        # availability: windows folded into the sampling logits; with every
        # client inside its window the tick freezes and t jumps to the thaw
        gone = (rand.leave_at <= t) & (t < rand.rejoin_at)
        logits = torch.where(gone, -torch.inf, log_probs)
        any_alive = (~gone).any()
        thaw_t = torch.clamp(
            torch.where(gone, rand.rejoin_at, NEVER).amin(), max=T)
        score = logits + rand.gumbels[e]
        if K == 1:
            js = torch.argmax(score).reshape(1)
        else:
            # Gumbel top-k: the tick's K distinct clients in sampling order
            js = torch.topk(score, K).indices
        tau_req = torch.floor(rand.tau_raw[e]).int().reshape(-1)
        taus = torch.minimum(tau_req, torch.clamp(n_upd, max=tau_max))
        w_stale = ring_read(ring, cursor, taus)
        payloads, losses = payload_fn(w_stale, js, noise.ticks[e])
        if K == 1:
            # a frozen K = 1 tick still writes its row in place: keep the
            # old one to restore (at K > 1 an all-invalid batch writes every
            # row back bit-exactly, so nothing needs saving)
            saved = {k: (state[k].data.index_select(0, js),
                         state[k].scale.index_select(0, js))
                     for k in cache_keys}
            proc = any_alive
            new_state, u, emit, lr_scale = agg.step(
                state, Arrival(js, payloads[0], t, taus[0]))
            loss = losses[0]
        else:
            saved = {}
            valid = ~gone[js]
            proc = valid.any()
            new_state, u, emit, lr_scale = agg.step_batch(
                state, ArrivalBatch(js, payloads, t, taus, valid))
            loss = (torch.where(valid, losses, 0.0).sum()
                    / torch.clamp(valid.sum(), min=1))
        emit = emit & (t < T) & proc
        # frozen ticks perform no aggregator transition
        state = _select_state(proc, new_state, state, saved, js)
        eta = lr_of_t(t) * lr_scale
        w = torch.where(emit, w - eta * u, w)
        ring, cursor = ring_append(ring, cursor, w, emit)
        outs["loss"][e] = loss
        outs["emit"][e] = emit
        outs["t"][e] = t
        outs["unorm"][e] = torch.linalg.vector_norm(u)
        outs["alive"][e] = any_alive
        if record_w:
            outs["w"][e] = w
        n_upd = n_upd + emit.int()
        t = torch.where(any_alive, t + emit.int(), thaw_t)

    host = {k: v.cpu().numpy() for k, v in outs.items()}
    return _to_result(w.cpu().numpy(), host, T, n if wants_init else 0)
