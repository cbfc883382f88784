"""Client delay models (paper §5: exponential wall-clock delays, mean β) —
a copy of `repro.core.delays` (plain numpy on the host, so the schedules
equal the JAX package's from the same seed).

`kappa` adds persistent client-rate heterogeneity: client i's mean delay is
β · s_i with s_i log-spaced in [1/(1+κ), 1+κ] — fast clients arrive more
often, which is exactly the participation-imbalance regime the paper studies.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ExponentialDelays:
    beta: float = 5.0
    kappa: float = 0.0
    n_clients: int = 100
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.kappa > 0:
            lo, hi = 1.0 / (1.0 + self.kappa), 1.0 + self.kappa
            self.scales = np.exp(np.linspace(np.log(lo), np.log(hi),
                                             self.n_clients))
            self._rng.shuffle(self.scales)
        else:
            self.scales = np.ones(self.n_clients)

    def sample(self, client: int) -> float:
        return float(self._rng.exponential(self.beta * self.scales[client]))


@dataclasses.dataclass
class Schedule:
    """Host-precomputed event schedule for the device-resident scan engine.

    arrive[e]   — client whose result the server processes at event e
    dispatch[e] — client handed the fresh model right after event e
    """
    arrive: np.ndarray       # (n_events,) int32
    dispatch: np.ndarray     # (n_events,) int32

    @property
    def n_events(self) -> int:
        return self.arrive.size


def build_schedule(delays: ExponentialDelays, n_events: int,
                   concurrency: int | None = None, seed: int = 0) -> Schedule:
    """Pre-simulate the event queue on host, mirroring the semantics of the
    JAX package's `AFLSimulator.run` exactly (same delay stream, same
    initial-running choice, same idle rotation) so that, given matching
    seeds, the scan engine replays the event-driven simulator's trajectory.

    With ``concurrency < n`` a finishing client goes to the back of the idle
    pool and a uniformly-drawn idle client is dispatched instead — every
    client participates (the previous schedule builder re-dispatched the
    finisher forever, so idle clients never ran)."""
    import heapq
    # replay from a fresh copy: never consume the caller's delay RNG, so a
    # delays instance shared with a simulator still yields the fresh-stream
    # schedule the equivalence contract promises
    delays = dataclasses.replace(delays)
    n = delays.n_clients
    c = min(concurrency or n, n)
    rng = np.random.default_rng(seed)
    if c < n:
        running = list(rng.choice(n, size=c, replace=False))
    else:
        running = list(range(n))
    running_set = set(running)
    idle = [i for i in range(n) if i not in running_set]
    heap: list = []
    seq = 0
    for i in running:
        heapq.heappush(heap, (delays.sample(i), seq, i))
        seq += 1
    arrive = np.zeros(n_events, np.int32)
    dispatch = np.zeros(n_events, np.int32)
    for e in range(n_events):
        now, _, j = heapq.heappop(heap)
        arrive[e] = j
        if c >= n or not idle:
            nxt = j
        else:
            idle.append(j)
            nxt = idle.pop(int(rng.integers(len(idle))))
        dispatch[e] = nxt
        heapq.heappush(heap, (now + delays.sample(nxt), seq, nxt))
        seq += 1
    return Schedule(arrive, dispatch)


def arrival_schedule(delays: ExponentialDelays, n_events: int,
                     concurrency: int | None = None,
                     seed: int = 0) -> np.ndarray:
    """Pre-simulate the arrival order (client id per server iteration) for the
    distributed/pjit path, where the schedule must be a static input array."""
    return build_schedule(delays, n_events, concurrency, seed).arrive
