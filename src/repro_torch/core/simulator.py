"""Event-driven asynchronous-FL simulator — the paper's experimental
protocol, the host reference of the event engine (`scan_engine.run_scan`).
Port of `repro.core.simulator`.

  * n clients compute on the model version they last received (wall-clock
    exponential delays); the server processes arrivals in time order.
  * One *server iteration* t = one global model update (buffered algorithms
    advance t once per buffer flush, exactly as the paper counts T).
  * Staleness τ = t − t_received, measured in server iterations.
  * Concurrency M_c: how many clients compute simultaneously (paper Table
    a.4: ACE/ACED = n, FedBuff/CA²FL = 20, Vanilla ASGD = 1).
  * Optional permanent dropouts at a given server iteration (paper Fig. 3).

The loop is driven from the host, one event at a time (a heapq event
queue); the model, the rule's state and the payloads live on the device.
The protocol draws (concurrency, idle rotation, dropout) come from
``np.random.default_rng(seed)`` and the delays from `ExponentialDelays`, as
in the JAX package, so the arrival order is `build_schedule`'s. The payload
noise is read by event index — the e-th heap pop reads
``payload_noise.ticks[e]``, init client i ``payload_noise.init[i]`` — which
is what `run_scan`'s tick reads; without `payload_noise` the simulator
draws it as `run_scan` does from the same seed. The host loop syncs with
the device a few times per event (`Aggregator.on_arrival`, the loss, the
update norm): it is the slow reference by design.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import ravel, unravel
from repro_torch.core.aggregators import Aggregator, Arrival, wants_cache_init
from repro_torch.core.delays import ExponentialDelays
from repro_torch.core.scan_engine import (PayloadNoise, _payload_chain,
                                          build_payload_noise,
                                          default_n_events)
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class SimResult:
    ts: List[int]
    losses: List[float]
    evals: List[Dict]
    eval_ts: List[int]
    total_comms: int
    update_norms: List[float]
    #: guard-pipeline counters (quarantined/clipped/rejected) — populated by
    #: the staleness simulator when fault guards are on, else empty
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)

    def final_eval(self):
        return self.evals[-1] if self.evals else {}


def _more_noise_seed(seed: int) -> int:
    """The seed of the generator that extends a run's payload noise past
    its budget: a stream of its own, neither `build_payload_noise`'s for
    this seed nor for another."""
    state = np.random.SeedSequence((int(seed), 0x5EED)).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


class _HostNoise:
    """A host run's payload noise, read by event index. Noise the simulator
    drew itself grows when a run goes past its budget (rows drawn from a
    generator seeded from the run's seed); noise a caller passed raises
    there."""

    def __init__(self, grad_fn, given: Optional[PayloadNoise], seed: int,
                 n_events: int, n_clients: int, k_batch: int,
                 local_steps: int, device: torch.device):
        self.grad_fn, self.device = grad_fn, device
        self._gen = None
        if given is None:
            given = build_payload_noise(grad_fn, seed, n_events, n_clients,
                                        k_batch, local_steps, device)
            self._gen = torch.Generator(device=device).manual_seed(
                _more_noise_seed(seed))
        if tuple(given.ticks.shape[1:3]) != (k_batch, local_steps):
            raise ValueError(
                f"payload noise ticks of shape {tuple(given.ticks.shape)} "
                f"for k_batch={k_batch}, local_steps={local_steps}")
        self.init = given.init.to(device)
        self.ticks = given.ticks.to(device)

    def tick(self, e: int) -> torch.Tensor:
        """Event `e`'s rows, ``(k_batch, local_steps, *noise_shape)``."""
        rows = self.ticks.shape[0]
        if e >= rows:
            if self._gen is None:
                raise ValueError(f"event {e} of a run given payload noise "
                                 f"for {rows} events")
            more = self.grad_fn.sample_noise(
                (max(rows, e + 1 - rows, 1),) + tuple(self.ticks.shape[1:3]),
                self._gen, self.device)
            self.ticks = torch.cat([self.ticks, more])
        return self.ticks[e]


class _HostRun:
    """What both host simulators share: the model on the device, the
    batched client payload (`scan_engine._payload_chain`, the engines'
    own) and the server lr as a 0-d f32 device tensor, as the engines
    compute them."""

    def __init__(self, grad_fn, params0, server_lr, local_steps, local_lr,
                 eval_fn, eval_every, device):
        self.device = resolve_device(device)
        # the client gradients are computed in f32, as the engines do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.grad_fn, self.params0 = grad_fn, params0
        self.w = ravel(params0).to(device=self.device,
                                   dtype=torch.float32).clone()
        self.d = self.w.numel()
        self.server_lr = server_lr
        self.local_steps, self.local_lr = local_steps, local_lr
        self.eval_fn, self.eval_every = eval_fn, eval_every
        self._payload_fn = _payload_chain(grad_fn, local_steps, local_lr)

    def _payload(self, w, clients, noise):
        """Payloads and losses of ``len(clients)`` lanes at models ``w (B,
        d)`` -> ``(payloads (B, d) f32, losses (B,))``."""
        clients = torch.as_tensor(np.asarray(clients, np.int64),
                                  device=self.device)
        return self._payload_fn(w, clients, noise)

    def _lr(self, t: int) -> torch.Tensor:
        """The server lr at iteration t: a constant, or the schedule called
        with the 0-d int32 iteration tensor, as the engines call it."""
        if callable(self.server_lr):
            lr = self.server_lr(torch.full((), t, dtype=torch.int32,
                                           device=self.device))
        else:
            lr = self.server_lr
        return torch.as_tensor(lr, dtype=torch.float32).to(self.device)

    def _init(self, agg: Aggregator, n: int, init_cache_grads: bool,
              noise: _HostNoise):
        """The init batch (one payload per client at w⁰, for the cache-init
        rules) and u⁰ applied before the loop (paper Alg. 1 lines 1, 4-5)
        -> (state, t, client uploads)."""
        if not (init_cache_grads and wants_cache_init(agg)):
            return agg.init_state(n, self.d, None, self.device), 0, 0
        rows, _ = self._payload(self.w[None].repeat(n, 1), np.arange(n),
                                noise.init)
        state = agg.init_state(n, self.d, rows, self.device)
        self.w = self.w - self._lr(0) * rows.mean(0)
        return state, 1, n

    def _apply(self, update, lr_scale: float, t: int):
        """``w ← w − η·update`` in f32 with ``η = f32(lr(t))·f32(lr_scale)``
        (a bf16 update too, as JAX's host casts it). The model is replaced,
        never written in place, so a reference to an earlier model (a
        client's copy, the staleness history) stays it."""
        self.w = self.w - (self._lr(t) * lr_scale) * update.float()

    def _eval(self, res: SimResult, t: int, T: int):
        if self.eval_fn and (t % self.eval_every == 0 or t == T):
            res.evals.append(self.eval_fn(unravel(self.w, self.params0)))
            res.eval_ts.append(t)


class AFLSimulator(_HostRun):
    def __init__(self, *, grad_fn: Callable, params0, aggregator: Aggregator,
                 n_clients: int, server_lr, delays: ExponentialDelays,
                 local_steps: int = 1, local_lr: float = 0.05,
                 concurrency: Optional[int] = None,
                 eval_fn: Optional[Callable] = None, eval_every: int = 50,
                 dropout_frac: float = 0.0, dropout_at: Optional[int] = None,
                 init_cache_grads: bool = True, seed: int = 0,
                 payload_noise: Optional[PayloadNoise] = None, device=None):
        """`grad_fn` is batched (`repro_torch.core.fl_tasks.ClientGrad`);
        `server_lr` a float or a callable of the 0-d int32 iteration
        tensor. `payload_noise` replaces the noise drawn from `seed` (one
        tick row per heap pop: a pop of a dropped client consumes its row
        unread). On the GPU unless ``device="cpu"``."""
        super().__init__(grad_fn, params0, server_lr, local_steps, local_lr,
                         eval_fn, eval_every, device)
        self.agg = aggregator
        self.n = n_clients
        self.delays = delays
        self.concurrency = concurrency or n_clients
        self.dropout_frac = dropout_frac
        self.dropout_at = dropout_at
        self.init_cache_grads = init_cache_grads
        self.seed = seed
        self.payload_noise = payload_noise
        self.rng = np.random.default_rng(seed)

    def run(self, T: int) -> SimResult:
        n = self.n
        noise = _HostNoise(
            self.grad_fn, self.payload_noise, self.seed,
            default_n_events(self.agg, T, self.init_cache_grads), n, 1,
            self.local_steps, self.device)
        state, t, total_comms = self._init(self.agg, n,
                                           self.init_cache_grads, noise)

        # --- event queue -------------------------------------------------
        heap: list = []
        seq = 0
        t_received = np.zeros(n, np.int64)
        w_received = {}
        if self.concurrency < n:
            running = list(self.rng.choice(n, size=self.concurrency,
                                           replace=False))
        else:
            running = list(range(n))
        running_set = set(running)
        idle = [c for c in range(n) if c not in running_set]
        now = 0.0
        for c in running:
            heapq.heappush(heap, (now + self.delays.sample(c), seq, c))
            seq += 1
            t_received[c] = t
            w_received[c] = self.w

        dropped = set()
        res = SimResult([], [], [], [], 0, [])
        e = 0                                   # heap pops: the noise row
        while t < T:
            if not heap:
                break
            now, _, j = heapq.heappop(heap)
            e += 1
            if j in dropped:
                continue
            payload, loss = self._payload(w_received[j][None], [j],
                                          noise.tick(e - 1))
            total_comms += 1
            staleness = int(t - t_received[j])
            state, update, lr_scale = self.agg.on_arrival(
                state, Arrival(int(j), payload[0], t, staleness))
            if update is not None:
                self._apply(update, lr_scale, t)
                res.ts.append(t)
                res.losses.append(float(loss[0]))
                res.update_norms.append(float(torch.linalg.vector_norm(
                    update)))
                t += 1
                self._eval(res, t, T)
            # dropout trigger
            if (self.dropout_at is not None and t >= self.dropout_at
                    and self.dropout_frac > 0 and not dropped):
                k = int(self.dropout_frac * n)
                dropped = set(self.rng.choice(n, size=k,
                                              replace=False).tolist())
            # redispatch
            if j not in dropped:
                if self.concurrency >= n or not idle:
                    nxt = j
                else:
                    idle.append(j)
                    nxt = idle.pop(int(self.rng.integers(len(idle))))
                if nxt not in dropped:
                    t_received[nxt] = t
                    w_received[nxt] = self.w
                    heapq.heappush(heap,
                                   (now + self.delays.sample(nxt), seq, nxt))
                    seq += 1
        res.total_comms = total_comms
        return res
