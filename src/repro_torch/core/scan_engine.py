"""Pieces of `repro.core.scan_engine` the staleness engine shares: the
trajectory record (`ScanResult`, `_to_result`, with the eval cadence's
``evals``/``eval_ts`` and the guard pipeline's ``faults`` counters), the
event budget (`default_n_events`, for every
rule of the zoo) and the client payload chain (`_payload_chain`). The event
engine itself (`run_scan`, `sweep`) is not ported yet (ROADMAP A8)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.aggregators import Aggregator, wants_cache_init


@dataclasses.dataclass
class ScanResult:
    """Trajectory of one run, on the host (emit-filtered like the JAX
    package's)."""
    ts: np.ndarray             # (n_updates,) server iteration per emitted update
    losses: np.ndarray         # (n_updates,) client loss at the emitting event
    update_norms: np.ndarray   # (n_updates,) ‖update‖₂
    w: np.ndarray              # (d,) final model
    total_comms: int
    emit: np.ndarray           # (n_events,) raw emission mask
    ws: Optional[np.ndarray] = None   # (n_events, d) model after each event
    #: the host `eval_fn`'s result at each eval mark the run reached, and
    #: those marks (server iterations)
    evals: List[Dict] = dataclasses.field(default_factory=list)
    eval_ts: List[int] = dataclasses.field(default_factory=list)
    #: the guard pipeline's counters (quarantined/clipped/rejected) when
    #: the run had guards on, else empty
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)

    def final_eval(self) -> Dict:
        return self.evals[-1] if self.evals else {}


def _payload_chain(grad_fn: Callable, local_steps: int, local_lr: float):
    """Client payload over a batch of B lanes:
    ``payload(w (B, d), clients (B,), noise (B, L, ...)) -> (payload (B, d)
    f32, loss (B,))``, L = `local_steps`. One `grad_fn` call per local step,
    each on that step's noise slice; with L > 1 the payload is the local
    displacement ``(w_start − w_L) / (L·local_lr)``, as in the JAX chain."""
    L = local_steps

    def payload(w, clients, noise):
        if L == 1:
            loss, g = grad_fn(w, clients, noise[:, 0])
            return g.float(), loss
        w_start = w
        for s in range(L):
            loss, g = grad_fn(w, clients, noise[:, s])
            w = w - local_lr * g
        return ((w_start - w) / (L * local_lr)).float(), loss
    return payload


def default_n_events(aggregator: Aggregator, T: int,
                     init_cache_grads: bool = True) -> int:
    """Events needed to reach T server iterations: buffered rules emit every
    `buffer_size`-th arrival; cache-init rules consume iteration 0. Rules
    whose emission is not certain per flush (``guaranteed_emit = False``)
    get headroom. (Every rule of the zoo guarantees emission — ACED's
    arriving client always re-enters its active set — so none takes that
    branch; `_to_result` raises if a budget starves before T.)"""
    t0 = 1 if (init_cache_grads and wants_cache_init(aggregator)) else 0
    base = max(T - t0, 0) * int(getattr(aggregator, "buffer_size", 1))
    if not getattr(aggregator, "guaranteed_emit", True):
        base += max(base // 2, 16)
    return base


def _to_result(w, outs, T: int, n_init_comms: int, evals=None,
               eval_ts=None) -> ScanResult:
    """Host-side record of a run from its per-event outputs (numpy)."""
    emit = np.asarray(outs["emit"])
    ts = np.asarray(outs["t"])
    alive = np.asarray(outs["alive"])
    # events the host loop would pop: before T, and not while every client
    # is gone (the host reference stops there)
    processed = int(np.sum((ts < T) & alive))
    if emit.size:
        final_t = int(ts[-1]) + int(emit[-1])
        if final_t < T and alive[-1]:
            raise RuntimeError(
                f"scan event budget exhausted at t={final_t} < T={T} with "
                f"clients still available ({emit.size} events); pass a "
                f"larger n_events")
    faults = {k: int(np.asarray(outs[k]).sum())
              for k in ("quarantined", "clipped", "rejected") if k in outs}
    return ScanResult(
        ts=ts[emit], losses=np.asarray(outs["loss"])[emit],
        update_norms=np.asarray(outs["unorm"])[emit],
        w=np.asarray(w), total_comms=n_init_comms + processed, emit=emit,
        ws=np.asarray(outs["w"]) if "w" in outs else None,
        evals=list(evals) if evals else [],
        eval_ts=list(eval_ts) if eval_ts else [], faults=faults)
