"""Sampled-staleness AFL simulator — the paper's Fig. 2 protocol, and the
host reference of the staleness engine (`scan_staleness`). Port of
`repro.core.staleness_sim`, with the protocol's constants the engine
shares.

At each server iteration t an arriving client j_t (uniform, or
speed-weighted to create participation imbalance) contributes a gradient
computed with a *fresh* sample on the stale model w^{t−τ}, τ ~ Exp(β)
(capped at τ_max, Assumption 5). The server keeps a bounded model history
to serve stale reads.

The loop is driven from the host one event at a time; the model, the
history, the rule's state and the payloads live on the device. The
protocol's draws (client, τ, the legacy dropout set) come from
``np.random.default_rng(seed)`` as in the JAX package, or, in replay mode,
from a `StalenessRandomness` — the stream the engine consumes, read at the
event cursor ``e``. The payload noise is read at the same cursor: tick e,
lane k reads ``payload_noise.ticks[e, k]``. A frozen, quarantined or
rejected event advances the cursor and leaves its rows unread, which is
how the engine's tick consumes them.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.aggregators import Aggregator, Arrival, ArrivalBatch
from repro_torch.core.scan_engine import PayloadNoise, default_n_events
from repro_torch.core.simulator import SimResult, _HostNoise, _HostRun

#: sentinel iteration for "never": a client with ``leave_at == NEVER`` is
#: always on; one with ``rejoin_at == NEVER`` never comes back.
NEVER: int = int(np.iinfo(np.int32).max)

#: per-event fault kinds of a `FaultSchedule`: NONE passes the payload
#: through; NAN poisons it with a non-finite multiplier (quarantined by the
#: guard pipeline); EXPLODE scales it by the schedule's per-event scale
#: (caught by global-norm clipping); BYZANTINE flips its sign (finite:
#: clipped, never quarantined); OVERSTALE forces the requested staleness
#: past tau_max (rejected by the over-stale guard).
FAULT_NONE: int = 0
FAULT_NAN: int = 1
FAULT_EXPLODE: int = 2
FAULT_BYZANTINE: int = 3
FAULT_OVERSTALE: int = 4


def default_tau_max(beta: float) -> int:
    """History bound when none is given; covers essentially all Exp(β)
    draws (P[τ > 6β+20] < e⁻⁶)."""
    return int(6 * beta + 20)


def staleness_client_probs(n_clients: int, speed_skew: float) -> np.ndarray:
    """Participation probabilities: uniform, or log-spaced speed weights in
    [1/(1+skew), 1+skew] (normalised) to create participation imbalance."""
    if speed_skew > 0:
        w = np.exp(np.linspace(-np.log(1 + speed_skew),
                               np.log(1 + speed_skew), n_clients))
        return w / w.sum()
    return np.full(n_clients, 1.0 / n_clients)


def _window_slack(n_clients: int, rejoin_at, windows) -> int:
    """Extra events for freeze fast-forward jumps: each all-gone freeze
    burns exactly one event and jumps to a strictly later rejoin, so at most
    `n_clients` events are ever lost to freezes."""
    return n_clients if (rejoin_at is not None or windows is not None) else 0


def _host(x, dtype) -> np.ndarray:
    """A host copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.array(x, dtype=dtype)


class StalenessSimulator(_HostRun):
    def __init__(self, *, grad_fn: Callable, params0, aggregator: Aggregator,
                 n_clients: int, server_lr, beta: float = 5.0,
                 tau_max: Optional[int] = None, speed_skew: float = 0.0,
                 local_steps: int = 1, local_lr: float = 0.05,
                 eval_fn: Optional[Callable] = None, eval_every: int = 50,
                 dropout_frac: float = 0.0, dropout_at: Optional[int] = None,
                 rejoin_at: Optional[int] = None, windows=None,
                 init_cache_grads: bool = True, seed: int = 0, replay=None,
                 faults=None, clip_norm: float = 0.0,
                 resync_every: Optional[int] = None, k_batch: int = 1,
                 payload_noise: Optional[PayloadNoise] = None, device=None):
        """`grad_fn` is batched (`repro_torch.core.fl_tasks.ClientGrad`);
        `server_lr` a float or a callable of the 0-d int32 iteration
        tensor. On the GPU unless ``device="cpu"``.

        `replay` (a `StalenessRandomness`) switches the protocol's draws
        from this instance's numpy RNG to the engine's pre-drawn stream,
        read at the event cursor, so host and engine can be compared event
        for event; the run stops early if the stream runs out.
        `payload_noise` replaces the noise drawn from `seed` (sized as
        `run_staleness_scan` sizes it: the replay stream's events, else the
        rule's event budget plus the window slack); noise the simulator
        drew itself grows when a non-replay run goes past its budget.

        Availability: ``windows = (leave_at, rejoin_at)`` gives explicit
        (n,) per-client windows (client i is unavailable while ``leave_at[i]
        <= t < rejoin_at[i]``). Without it (and without `replay`, whose
        windows are used), the legacy `dropout_frac`/`dropout_at` trigger
        draws the leaving set from `self.rng` once when t first reaches
        `dropout_at` (plus an optional scalar `rejoin_at`).

        Fault guards (the engine's guard pipeline, lane by lane): `faults`
        is a `FaultSchedule` indexed by the event cursor — a NaN payload is
        quarantined (the event is consumed without touching model, state or
        history), EXPLODE/BYZANTINE payloads pass through global-norm
        clipping when `clip_norm > 0`, OVERSTALE events (and natural draws
        past tau_max while guards are on) are rejected. `resync_every`
        re-derives the rule's running sums from its cache every that many
        emitted updates. Counters land on ``SimResult.faults``.

        `k_batch > 1` is the host reference of the engine's K-arrival
        ticks: each tick takes the top-K Gumbel-perturbed clients (as the
        engine selects them, with `torch.topk`), computes the K lane
        payloads as one batch, runs the guards per lane and hands the
        surviving lanes to `Aggregator.on_batch` as one `ArrivalBatch`. It
        requires `replay`, and a `faults` schedule with per-lane ``(E,
        k_batch)`` kinds."""
        super().__init__(grad_fn, params0, server_lr, local_steps, local_lr,
                         eval_fn, eval_every, device)
        self.agg = aggregator
        self.n = n_clients
        self.beta = beta
        self.tau_max = (tau_max if tau_max is not None
                        else default_tau_max(beta))
        self.dropout_frac = dropout_frac
        self.dropout_at = dropout_at
        self.rejoin_at = rejoin_at
        self.windows = windows
        self.init_cache_grads = init_cache_grads
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.replay = replay
        self.faults = faults
        self.clip_norm = float(clip_norm)
        self.resync_every = resync_every
        self.payload_noise = payload_noise
        self.k_batch = int(k_batch)
        if not 1 <= self.k_batch <= n_clients:
            raise ValueError(
                f"k_batch must be in [1, n_clients]; got {k_batch} with "
                f"n_clients={n_clients}")
        if self.k_batch > 1 and replay is None:
            raise ValueError(
                "k_batch > 1 requires a replay stream: the host K-batch "
                "reference mirrors the engine's Gumbel top-k draw, which "
                "only exists against a pre-drawn StalenessRandomness "
                "(build_staleness_randomness(..., k_batch=k_batch))")
        self.client_probs = staleness_client_probs(n_clients, speed_skew)
        # the engine's f32 logits, so that argmax and top-k see its values
        self._log_probs = np.log(self.client_probs).astype(np.float32)

    def _guard(self, payloads, kind, fscale, tau_req, valid, counts):
        """The guard pipeline over a tick's (K, d) lanes, in place on
        `valid` and `counts`: each lane's fault multiplier (× NaN, ×
        scale for EXPLODE, × −1 for BYZANTINE, in f32), then per live lane
        quarantine if not finite, else reject if over-stale, else clip to
        `clip_norm`. -> the guarded payloads."""
        f32 = np.float32
        mult = np.where(kind == FAULT_NAN, f32(np.nan), f32(1.0))
        mult = np.where(kind == FAULT_EXPLODE, mult * fscale, mult)
        mult = np.where(kind == FAULT_BYZANTINE, -mult, mult).astype(f32)
        payloads = payloads * torch.from_numpy(mult).to(self.device)[:, None]
        finite = torch.isfinite(payloads).all(1).cpu().numpy()
        gnorm = torch.linalg.vector_norm(payloads, dim=1).cpu().numpy()
        clip = f32(self.clip_norm)
        cscale = np.ones(len(valid), f32)
        for k in np.flatnonzero(valid):
            if not finite[k]:
                counts["quarantined"] += 1
                valid[k] = False
            elif tau_req[k] > self.tau_max:
                counts["rejected"] += 1
                valid[k] = False
            elif clip > 0 and gnorm[k] > clip:
                cscale[k] = clip / max(gnorm[k], f32(1e-12))
                counts["clipped"] += 1
        return payloads * torch.from_numpy(cscale).to(self.device)[:, None]

    def run(self, T: int) -> SimResult:
        n, K, dev = self.n, self.k_batch, self.device
        replay = self.replay
        if replay is not None:                  # hoisted to the host once
            r_gumbels = _host(replay.gumbels, np.float32)
            r_tau_raw = _host(replay.tau_raw, np.float32)
            n_events = n_replay = r_tau_raw.shape[0]
        else:
            n_events = (default_n_events(self.agg, T, self.init_cache_grads)
                        + _window_slack(n, self.rejoin_at, self.windows))
        noise = _HostNoise(self.grad_fn, self.payload_noise, self.seed,
                           n_events, n, K, self.local_steps, dev)
        history: deque = deque(maxlen=self.tau_max + 1)
        history.append(self.w)
        state, t, total_comms = self._init(self.agg, n,
                                           self.init_cache_grads, noise)
        if t:
            history.append(self.w)

        res = SimResult([], [], [], [], 0, [])
        # fault guards: the engine's guard pipeline, event for event
        guards_on = self.faults is not None or self.clip_norm > 0
        f_kind = f_scale = None
        if self.faults is not None:
            f_kind = _host(self.faults.kind, np.int64)
            f_scale = _host(self.faults.scale, np.float32)
            want_ndim = 2 if K > 1 else 1
            if f_kind.ndim != want_ndim:
                raise ValueError(
                    f"fault schedule has {f_kind.ndim}-D kinds but "
                    f"k_batch={K}: rebuild with "
                    f"build_fault_schedule(..., k_batch={K})")
        counts = {"quarantined": 0, "clipped": 0, "rejected": 0}
        n_upd = t                               # emitted-update counter
        # availability windows: client i is unavailable while
        # leave_at[i] <= t < rejoin_at[i]
        if self.windows is not None:
            leave_at = _host(self.windows[0], np.int64)
            rejoin_at = _host(self.windows[1], np.int64)
        elif replay is not None:
            leave_at = _host(replay.leave_at, np.int64)
            rejoin_at = _host(replay.rejoin_at, np.int64)
        else:
            leave_at = np.full(n, NEVER, np.int64)
            rejoin_at = np.full(n, NEVER, np.int64)
        # legacy dropout trigger: one-shot (disarmed after it fires, whatever
        # k resolves to, so that a k = 0 draw leaves the stream alone)
        armed = (self.windows is None and replay is None
                 and self.dropout_at is not None and self.dropout_frac > 0)
        e = 0                                   # the event cursor
        while t < T:
            if replay is not None and e >= n_replay:
                break                           # replay stream exhausted
            if armed and t >= self.dropout_at:
                armed = False
                k = int(self.dropout_frac * n)
                if k > 0:
                    idx = self.rng.choice(n, size=k, replace=False,
                                          p=self.client_probs)
                    leave_at[idx] = self.dropout_at
                    rejoin_at[idx] = (self.rejoin_at
                                      if self.rejoin_at is not None else NEVER)
            gone = (leave_at <= t) & (t < rejoin_at)
            if gone.all():
                # no client available: no arrival can happen at iteration t —
                # the event is consumed and t fast-forwards to the earliest
                # rejoin (the loop ends if none comes before T)
                e += 1
                t = int(min(rejoin_at.min(), T))
                continue
            if replay is not None:
                # the engine's f32 arithmetic: log-probs masked to -inf plus
                # the event's Gumbel row
                scores = (np.where(gone, -np.inf, self._log_probs)
                          .astype(np.float32) + r_gumbels[e])
                if K == 1:
                    js = np.array([np.argmax(scores)])
                else:
                    # the engine's Gumbel top-k; the order it gives tied
                    # -inf (gone) lanes does not change the state: they are
                    # invalid lanes
                    js = torch.topk(torch.from_numpy(scores),
                                    K).indices.numpy()
                tau_req = np.floor(r_tau_raw[e]).astype(np.int64).reshape(K)
            else:
                if gone.any():
                    alive = np.where(gone, 0.0, self.client_probs)
                    probs = alive / alive.sum()
                else:      # bit-identical to the draw without windows
                    probs = self.client_probs
                js = np.array([self.rng.choice(n, p=probs)])
                tau_req = np.array([int(self.rng.exponential(self.beta))])
            kind = np.full(K, FAULT_NONE, np.int64)
            fscale = np.ones(K, np.float32)
            if f_kind is not None and e < f_kind.shape[0]:
                kind = f_kind[e].reshape(K)
                fscale = f_scale[e].reshape(K)
            tau_req = np.where(kind == FAULT_OVERSTALE, self.tau_max + 1,
                               tau_req)
            taus = np.minimum(tau_req, min(self.tau_max, len(history) - 1))
            w_stale = torch.stack([history[-(int(tau) + 1)] for tau in taus])
            payloads, losses = self._payload(w_stale, js, noise.tick(e))
            e += 1
            valid = ~gone[js]                   # live lanes
            total_comms += int(valid.sum())
            if guards_on:
                payloads = self._guard(payloads, kind, fscale, tau_req, valid,
                                       counts)
            if not valid.any():
                continue            # the event is consumed; nothing touched
            if K == 1:
                state, update, lr_scale = self.agg.on_arrival(
                    state, Arrival(int(js[0]), payloads[0], t, int(taus[0])))
                loss = float(losses[0])
            else:
                valid_t = torch.from_numpy(valid).to(dev)
                batch = ArrivalBatch(
                    clients=torch.from_numpy(js).to(dev), payloads=payloads,
                    t=t, staleness=torch.from_numpy(
                        taus.astype(np.int32)).to(dev), valid=valid_t)
                state, update, lr_scale = self.agg.on_batch(state, batch)
                # the loss averaged over the valid lanes, in f32
                loss = float(torch.where(valid_t, losses, 0.0).sum()
                             / torch.clamp(valid_t.sum(), min=1))
            if update is None:
                continue
            self._apply(update, lr_scale, t)
            history.append(self.w)
            res.ts.append(t)
            res.losses.append(loss)
            res.update_norms.append(float(torch.linalg.vector_norm(update)))
            t += 1
            n_upd += 1
            if self.resync_every and n_upd % self.resync_every == 0:
                # the exact self-heal of the running sums, on emitted
                # updates (not events), as the engine counts them
                state = self.agg.resync(state)
            self._eval(res, t, T)
        res.total_comms = total_comms
        if guards_on:
            res.faults = counts
        return res
