"""The event-driven engine (the paper's wall-clock protocol), and what the
port's two engines share — the counterpart of `repro.core.scan_engine`.

The event engine. The event queue depends only on the delay model, never
on model values, so `build_schedule` (`repro_torch.core.delays`) replays
it once on the host into ``arrive[e]`` (whose result the server processes
at event e) and ``dispatch[e]`` (who receives the fresh model afterwards).
The device runs one tick per event: the arriving client's payload at the
model it received (``w_recv (n, d)`` of the carry), staleness ``τ = t −
t_recv[j]``, the rule's `step`, the update applied when the rule emits
(gated at ``t < T``; t advances only on emitted updates), and the
dispatched client's ``t_recv``/``w_recv`` set to the new iteration and
model. K = 1: the JAX event engine has no batched form.

Shared by both engines (`scan_staleness` builds on it): the trajectory
record (`ScanResult`, `_to_result`), the event budget
(`default_n_events`), the payload chain (`_payload_chain`) and its noise
(`PayloadNoise`, `build_payload_noise`), and the runner machinery: a
program is an ``init`` and a ``tick`` over a carry of tensors (`_Program`);
`_Ticks` steps it over static buffers, eagerly or by replays of one tick
captured as a CUDA graph, and `_TickRunner` calls it once per run. With
the sanitize checks on (`repro_torch.core.sanitize`), the carry holds the
checks' records and the runner raises after the run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import ravel, tree_map
from repro_torch.core import sanitize
from repro_torch.core.aggregators import (ALGORITHMS, Aggregator, Arrival,
                                          wants_cache_init)
from repro_torch.core.cache import FlatCache, cache_tensors
from repro_torch.core.delays import ExponentialDelays, build_schedule
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.sharding.rules import warm_up_groups


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
    ``payload(w, clients (B,), noise (B, L, ...)) -> (payload, loss (B,))``,
    L = `local_steps`, where `w` is a (B, d) tensor (the flat layout) or a
    parameter structure whose leaves lead with (B,) (the tree layout; JAX's
    `_tree_payload_chain`: a tensor is a structure of one leaf, so the flat
    chain is the same ops), the payload in `w`'s form in f32. One
    `grad_fn` call per local step, each on that step's noise slice; with
    L > 1 the payload is the local displacement ``(w_start − w_L) /
    (L·local_lr)`` per leaf, as in the JAX chain."""
    L = local_steps

    def payload(w, clients, noise):
        if L == 1:
            loss, g = grad_fn(w, clients, noise[:, 0])
            return tree_map(lambda x: x.float(), g), loss
        w_start = w
        for s in range(L):
            loss, g = grad_fn(w, clients, noise[:, s])
            w = tree_map(lambda a, b: a - local_lr * b, w, g)
        return tree_map(lambda a, b: ((a - b) / (L * local_lr)).float(),
                        w_start, w), loss
    return payload


@dataclasses.dataclass
class PayloadNoise:
    """The noise every client payload consumes, per local step: one row per
    client for the init batch and one per (tick, lane)."""
    init: torch.Tensor       # (n, local_steps, *noise_shape)
    ticks: torch.Tensor      # (n_events, k_batch, local_steps, *noise_shape)


def build_payload_noise(grad_fn, seed: int, n_events: int, n_clients: int,
                        k_batch: int = 1, local_steps: int = 1,
                        device=None) -> PayloadNoise:
    """Draw the payload noise of a run with ``grad_fn.sample_noise`` from a
    generator seeded with `seed` (a stream of its own, apart from the
    staleness engine's `build_staleness_randomness`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed + 0x5EED)
    init = grad_fn.sample_noise((n_clients, local_steps), gen, device)
    ticks = grad_fn.sample_noise((n_events, k_batch, local_steps), gen,
                                 device)
    return PayloadNoise(init, ticks)


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
    # the event engine has no availability: every event is alive
    alive = (np.asarray(outs["alive"]) if "alive" in outs
             else np.ones(emit.shape, bool))
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


# ---------------------------------------------------------------------------
# Running a tick: eagerly, or captured once as a CUDA graph and replayed.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Program:
    """One configuration of an engine: ``init(lr, init_noise, reuse=None)
    -> carry`` and ``tick(carry, xs, outs)``, which advances the carry by
    one event in place, reading row ``carry["e"]`` of the streams in `xs`
    and writing row ``e`` of `outs`. `reuse` is the carry the new one will
    be copied into (a runner's own, on its second and later calls): the
    program may build the new carry's largest buffers in its storage
    instead of allocating them again."""
    init: Callable
    tick: Callable
    d: int
    record_w: bool
    device: torch.device
    out_dtypes: Dict[str, torch.dtype]   # the per-event outputs
    #: the sanitize checks are in the tick (the carry holds their records)
    checks: bool
    #: the ("data", "model") mesh whose collectives the tick issues (None:
    #: one device); a capture first runs one collective on each of its
    #: groups and records the tick in thread-local capture mode, so the
    #: process group's own threads may touch the card meanwhile
    mesh: Any = dataclasses.field(default=None, kw_only=True)


def _tree_clone(x):
    """A copy of a carry (or of a part of one: dicts, lists, caches of
    either layout, tensors) sharing no storage with it."""
    if isinstance(x, dict):
        return {k: _tree_clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_clone(v) for v in x)
    if isinstance(x, FlatCache):
        return x.map_tensors(torch.Tensor.clone)
    return x.clone()


def _own(x, seen=None):
    """A fresh carry as a runner's own: its tensors kept, but a clone of
    any whose storage an earlier one of them shares (so that no two of its
    tensors alias each other)."""
    seen = set() if seen is None else seen
    if isinstance(x, dict):
        return {k: _own(v, seen) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_own(v, seen) for v in x)
    if isinstance(x, FlatCache):
        return x.map_tensors(lambda t: _own(t, seen))
    ptr = x.untyped_storage().data_ptr()
    if ptr in seen:
        return x.clone()
    seen.add(ptr)
    return x


def _tree_copy_(dst, src):
    """Copy carry `src` into carry `dst`, tensor by tensor (a tensor onto
    itself is no copy)."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"a carry with keys {sorted(src)} for a runner "
                             f"whose carry has {sorted(dst)}")
        for k in dst:
            _tree_copy_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"a carry list of {len(src)} entries for a "
                             f"runner whose carry has {len(dst)}")
        for a, b in zip(dst, src):
            _tree_copy_(a, b)
    elif isinstance(dst, FlatCache):
        for a, b in zip(cache_tensors(dst), cache_tensors(src)):
            a.copy_(b)
    else:
        dst.copy_(src)


def _copy_state_(agg: Aggregator, state, new_state) -> None:
    """A tick's copy-back of the rule's state: every new tensor into the
    carry's own (a cache of either layout was written in place and must
    come back as the same object; a fresh one would be lost to the next
    tick)."""
    for k, v in new_state.items():
        if cache_tensors(v):
            if v is not state[k]:
                raise RuntimeError(f"{type(agg).__name__}.step returned "
                                   f"a new cache for {k!r}")
        else:
            _tree_copy_(state[k], v)


def _write_outs(outs, e, row) -> None:
    """Write one event's outputs into row `e` (a (1,) index) of `outs`."""
    for k, v in row.items():
        outs[k].index_copy_(0, e, v.to(outs[k].dtype).reshape(
            (1,) + outs[k].shape[1:]))


def _use_graph(graph: Optional[bool], device: torch.device) -> bool:
    """None: capture on a CUDA device, run eagerly on the CPU."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("graph=True captures a CUDA graph: it needs a CUDA "
                         f"device, not {device}")
    return bool(graph)


_warmup_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device):
    """One side stream per device for every capture's warm-up tick: cuBLAS
    keeps a workspace for each stream it has run on, so a new stream per
    capture would hold one more workspace per capture for good."""
    if device not in _warmup_streams:
        _warmup_streams[device] = torch.cuda.Stream(device)
    return _warmup_streams[device]


class _Ticks:
    """A program's tick over static buffers for up to `capacity` events:
    the streams and the run's inputs (`feed`), the carry (`load`) and the
    per-event outputs. `run` steps the carry eagerly or, with `use_graph`,
    by replays of one tick captured the first time it runs; a capture that
    fails raises."""

    def __init__(self, prog: _Program, capacity: int, graph: bool):
        self.prog, self.capacity = prog, int(capacity)
        self.use_graph = graph
        dev = prog.device
        self.outs = {k: torch.zeros((self.capacity,), dtype=dt, device=dev)
                     for k, dt in prog.out_dtypes.items()}
        if prog.record_w:
            self.outs["w"] = torch.zeros((self.capacity, prog.d),
                                         device=dev)
        self.xs: Optional[Dict[str, torch.Tensor]] = None
        self.carry = None
        self.captures = 0
        self._graph = None
        self._per_tick: Dict[str, int] = {}   # kernel launches of one tick

    def feed(self, streams: Dict[str, torch.Tensor],
             inputs: Dict[str, torch.Tensor]) -> int:
        """Copy an event slice's `streams` (a leading axis of the slice's
        events) into the first rows of the static buffers and the run's
        `inputs` (windows, lr, ...) into theirs -> the slice's event
        count."""
        L = int(next(iter(streams.values())).shape[0])
        if L > self.capacity:
            raise ValueError(f"a slice of {L} events for a runner built for "
                             f"{self.capacity}")
        if self.xs is None:
            dev = self.prog.device
            self.xs = {k: torch.zeros((self.capacity,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=dev)
                       for k, v in streams.items()}
            self.xs.update({k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                            for k, v in inputs.items()})
        for k, v in streams.items():
            if v.shape[0] != L or v.shape[1:] != self.xs[k].shape[1:]:
                raise ValueError(f"{k} of shape {tuple(v.shape)} for {L} "
                                 f"events of a runner fed rows of "
                                 f"{tuple(self.xs[k].shape[1:])}")
            self.xs[k][:L].copy_(v)
        for k, v in inputs.items():
            self.xs[k].copy_(v)
        return L

    def load(self, carry, fresh: bool = False) -> None:
        """Copy `carry` into the carry the tick steps. The first one is
        cloned, so the tick's carry shares storage with nothing; a `fresh`
        one (a program's init, which nothing else holds) is taken as it is,
        only its aliased tensors cloned (`_own`), so that a full-width carry
        is never held twice."""
        if self.carry is None:
            self.carry = _own(carry) if fresh else _tree_clone(carry)
        else:
            _tree_copy_(self.carry, carry)

    def run(self, n: int) -> None:
        """`n` ticks of the loaded carry over the fed streams."""
        if not self.use_graph:
            for _ in range(n):
                self.prog.tick(self.carry, self.xs, self.outs)
            return
        if n > 0 and self._graph is None:
            self._capture()            # the first tick runs, the rest replay
            n -= 1
        for _ in range(n):
            self._graph.replay()
        kernel_ops.add_launch_counts(self._per_tick, n)

    def _capture(self) -> None:
        """Run the first tick eagerly on a side stream, as PyTorch asks of a
        capture that takes autograd (it also builds and loads the kernel
        libraries, cuBLAS's workspace and the rules' constants), then
        record the tick that follows it: a capture runs nothing, so the
        carry holds the first tick's result and no copy of it is kept."""
        dev = self.prog.device
        if self.prog.mesh is not None:
            warm_up_groups(self.prog.mesh, dev)
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.prog.tick(self.carry, self.xs, self.outs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernel_ops.launch_counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode=(
                    "global" if self.prog.mesh is None else "thread_local")):
                self.prog.tick(self.carry, self.xs, self.outs)
        finally:
            # the wrappers counted launches the capture only recorded
            after = kernel_ops.launch_counts()
            per_tick = {k: after[k] - before[k] for k in after}
            kernel_ops.add_launch_counts(per_tick, -1)
        self._graph, self._per_tick = graph, per_tick
        self.captures += 1


class _TickRunner:
    """A program run whole, once per call: the static buffers (and the
    graph) of the event count last run, rebuilt with a new capture when a
    call brings another count."""

    def __init__(self, prog: _Program, graph: bool):
        self.prog, self.use_graph = prog, graph
        self._ticks: Optional[_Ticks] = None
        self._retired = 0

    @property
    def captures(self) -> int:
        """CUDA graphs this runner has captured."""
        return self._retired + (self._ticks.captures if self._ticks else 0)

    @property
    def carry(self):
        """The whole carry the last call ended with (the runner's own
        tensors, which the next call overwrites), or None before a call."""
        return self._ticks.carry if self._ticks else None

    def _run(self, n_events: int, streams, inputs, init_noise) -> _Ticks:
        """Feed, init from ``inputs["lr"]`` and `init_noise`, run every
        event, and raise on a violated sanitize check."""
        ticks = self._ticks
        if ticks is None or ticks.capacity != n_events:
            self._retired = self.captures
            ticks = self._ticks = _Ticks(self.prog, n_events, self.use_graph)
        ticks.feed(streams, inputs)
        ticks.load(self.prog.init(ticks.xs["lr"], init_noise,
                                  reuse=ticks.carry), fresh=True)
        ticks.run(n_events)
        if self.prog.checks:
            sanitize.raise_first(ticks.carry["checks"])
        return ticks


# ---------------------------------------------------------------------------
# The event engine.
# ---------------------------------------------------------------------------

#: the per-event outputs of the event engine's tick
_SCAN_OUT_DTYPES = {"loss": torch.float32, "emit": torch.bool,
                    "t": torch.int32, "unorm": torch.float32}


def _scan_program(*, grad_fn: Callable, params0, aggregator: Aggregator,
                  n_clients: int, T: int, server_lr: Optional[Callable],
                  local_steps: int, local_lr: float, init_cache_grads: bool,
                  record_w: bool, checks: bool, device) -> _Program:
    """The event engine as an init and a tick (JAX's `make_scan_runner`
    body). ``init(lr, init_noise)``: the init batch (one payload per client
    at w⁰, for the cache-init rules) and u⁰ applied with `lr`; every client
    holds the model after it (``t_recv``, ``w_recv``). ``tick(carry, xs,
    outs)`` reads ``arrive``/``dispatch (E,)``, ``noise (E, 1, L, ...)`` at
    ``carry["e"]`` and the 0-d ``lr``. `server_lr` is None (the tick takes
    ``xs["lr"]``) or a callable of the 0-d int32 iteration tensor."""
    device = resolve_device(device)
    # the client gradients are compared with the JAX package's in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, agg = n_clients, aggregator
    lr_of_t = ((lambda t, lr: server_lr(t)) if server_lr is not None
               else (lambda t, lr: lr))
    wants_init = init_cache_grads and wants_cache_init(agg)
    payload_fn = _payload_chain(grad_fn, local_steps, local_lr)
    w0 = ravel(params0).to(device=device, dtype=torch.float32)
    d = w0.numel()

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    def init(lr, init_noise=None, reuse=None):
        # (`reuse`: nothing here is large enough to build in place)
        lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
        if wants_init:
            if init_noise is None:
                raise ValueError(
                    f"{type(agg).__name__} seeds its cache with one payload "
                    "per client: pass the init batch's noise "
                    "(PayloadNoise.init)")
            # one payload per client at w0 (paper Alg. 1 line 1), and u⁰
            # applied before the loop (lines 4-5)
            init_rows, _ = payload_fn(
                w0[None].repeat(n, 1), torch.arange(n, device=device),
                torch.as_tensor(init_noise).to(device))
            state = agg.init_state(n, d, init_rows, device)
            w, t0 = w0 - lr_of_t(i32(0), lr) * init_rows.mean(0), 1
        else:
            state = agg.init_state(n, d, None, device)
            w, t0 = w0.clone(), 0
        carry = {"w": w, "state": state, "t": i32(t0),
                 "t_recv": torch.full((n,), t0, dtype=torch.int32,
                                      device=device),
                 "w_recv": w[None].repeat(n, 1),
                 "e": torch.zeros((), dtype=torch.int64, device=device)}
        if checks:
            carry["checks"] = sanitize.records(
                [sanitize.MODEL, sanitize.PAYLOAD]
                + sanitize.state_messages(state), device)
        return carry

    def tick(carry, xs, outs):
        e = carry["e"].reshape(1)
        aj = xs["arrive"].index_select(0, e)             # (1,) int64
        dj = xs["dispatch"].index_select(0, e)
        t, state = carry["t"], carry["state"]
        payloads, losses = payload_fn(carry["w_recv"].index_select(0, aj),
                                      aj, xs["noise"].index_select(0, e)[0])
        staleness = t - carry["t_recv"].index_select(0, aj)[0]
        new_state, u, emit, lr_scale = agg.step(
            state, Arrival(aj, payloads[0], t, staleness))
        emit = emit & (t < T)
        eta = lr_of_t(t, xs["lr"]) * lr_scale
        # in f32, as JAX's (`_staleness_program`'s `apply_update`)
        w = torch.where(emit, carry["w"] - eta * u.float(), carry["w"])
        t_new = t + emit.int()
        row = {"loss": losses[0], "emit": emit, "t": t,
               "unorm": torch.linalg.vector_norm(u)}
        if record_w:
            row["w"] = w
        if checks:
            sanitize.record(
                carry["checks"],
                sanitize.check_model_finite(w)
                + sanitize.check_payload_finite(payloads[0], emit)
                + sanitize.check_aggregator_state(new_state, n), carry["e"])
        _write_outs(outs, e, row)
        # the state first: a rule may hand back the carry's own `t` (ACED's
        # t_prev), which the copy below overwrites
        _copy_state_(agg, state, new_state)
        carry["w"].copy_(w)
        carry["t"].copy_(t_new)
        carry["t_recv"].index_copy_(0, dj, t_new.reshape(1))
        carry["w_recv"].index_copy_(0, dj, w[None])
        carry["e"].add_(1)

    return _Program(init=init, tick=tick, d=d, record_w=record_w,
                    device=device, out_dtypes=dict(_SCAN_OUT_DTYPES),
                    checks=checks)


class _ScanRunner(_TickRunner):
    """``runner(arrive, dispatch, payload_noise) -> (w, state, outs)``; see
    `make_scan_runner`."""

    def __init__(self, prog: _Program, graph: bool, lr: float,
                 local_steps: int):
        super().__init__(prog, graph)
        self.lr, self.local_steps = lr, local_steps

    def __call__(self, arrive, dispatch, payload_noise: PayloadNoise):
        dev = self.prog.device
        arrive, dispatch = (torch.as_tensor(x).to(device=dev,
                                                  dtype=torch.int64)
                            for x in (arrive, dispatch))
        E = int(arrive.shape[0])
        if tuple(dispatch.shape) != (E,):
            raise ValueError(f"dispatch of shape {tuple(dispatch.shape)} for "
                             f"{E} arrivals")
        noise = payload_noise.ticks
        if tuple(noise.shape[:3]) != (E, 1, self.local_steps):
            raise ValueError(f"payload noise ticks of shape "
                             f"{tuple(noise.shape)} for {E} events, one "
                             f"lane, local_steps={self.local_steps}")
        ticks = self._run(
            E, {"arrive": arrive, "dispatch": dispatch, "noise": noise},
            {"lr": torch.full((), self.lr, dtype=torch.float32, device=dev)},
            payload_noise.init)
        return (ticks.carry["w"].clone(), _tree_clone(ticks.carry["state"]),
                {k: v.clone() for k, v in ticks.outs.items()})


def make_scan_runner(*, grad_fn: Callable, params0, aggregator: Aggregator,
                     n_clients: int, server_lr, T: int,
                     n_events: Optional[int] = None, local_steps: int = 1,
                     local_lr: float = 0.05, init_cache_grads: bool = True,
                     record_w: bool = False,
                     checkify_invariants: Optional[bool] = None,
                     device=None, graph: Optional[bool] = None):
    """Build the event engine's runner ``run(arrive, dispatch,
    payload_noise) -> (w, state, outs)`` once: the counterpart of the JAX
    package's jitted runner, with the payload noise (`PayloadNoise`, one
    tick row per event) in place of its PRNG key. `arrive`/`dispatch` are
    a `Schedule`'s arrays (numpy or tensors); the event count is theirs
    (`n_events` is accepted for the JAX package's signature). `grad_fn` is
    batched (`repro_torch.core.fl_tasks.ClientGrad`); `server_lr` a float,
    or a callable of the 0-d int32 iteration tensor. ``outs`` holds the
    per-event ``loss``, ``emit``, ``t``, ``unorm`` (and ``w`` with
    `record_w`), on the device.

    On a CUDA device the runner copies the schedule and the noise into
    static buffers, captures one tick as a CUDA graph (after the first
    tick, run eagerly on a side stream as PyTorch's warm-up) and replays it
    for every later event; ``graph=None``
    captures on CUDA and runs the same tick eagerly on the CPU,
    ``graph=False`` runs it eagerly on the card too, ``graph=True`` on the
    CPU raises, and a capture that fails raises. A call with another event
    count captures anew (``runner.captures`` counts them).

    ``checkify_invariants`` (default: the ``REPRO_CHECKIFY`` environment
    variable) puts the sanitize checks in the tick (model finite, applied
    payload finite, the rule's state in bounds): the run raises
    `RuntimeError` with the first violation's message and event after it
    ends. Off, the tick has no check op."""
    checks = sanitize.enabled(checkify_invariants)
    prog = _scan_program(
        grad_fn=grad_fn, params0=params0, aggregator=aggregator,
        n_clients=n_clients, T=T,
        server_lr=server_lr if callable(server_lr) else None,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, record_w=record_w, checks=checks,
        device=device)
    lr = 0.0 if callable(server_lr) else float(server_lr)
    return _ScanRunner(prog, _use_graph(graph, prog.device), lr, local_steps)


def _scan_result(run, T: int, n_init: int) -> ScanResult:
    """The host record of one event-engine runner call."""
    w, _, outs = run
    return _to_result(w.cpu().numpy(),
                      {k: v.cpu().numpy() for k, v in outs.items()}, T,
                      n_init)


def run_scan(*, grad_fn: Callable, params0, aggregator: Aggregator,
             n_clients: int, server_lr, delays: ExponentialDelays, T: int,
             n_events: Optional[int] = None,
             concurrency: Optional[int] = None, local_steps: int = 1,
             local_lr: float = 0.05, init_cache_grads: bool = True,
             seed: int = 0, record_w: bool = False, device=None,
             payload_noise: Optional[PayloadNoise] = None) -> ScanResult:
    """One run of the event-driven protocol: the schedule replayed on the
    host from `delays`, `concurrency` and `seed` (the JAX package's arrays),
    the payload noise drawn from a generator seeded with `seed` unless
    `payload_noise` is given (the tests replay the JAX package's key chain
    through it), the events run by `make_scan_runner` (a captured CUDA
    graph on the card). On the GPU unless ``device="cpu"``."""
    device = resolve_device(device)
    if n_events is None:
        n_events = default_n_events(aggregator, T, init_cache_grads)
    sched = build_schedule(delays, n_events, concurrency, seed)
    runner = make_scan_runner(
        grad_fn=grad_fn, params0=params0, aggregator=aggregator,
        n_clients=n_clients, server_lr=server_lr, T=T, n_events=n_events,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, record_w=record_w, device=device)
    if payload_noise is None:
        payload_noise = build_payload_noise(grad_fn, seed, n_events,
                                            n_clients, 1, local_steps, device)
    wants_init = init_cache_grads and wants_cache_init(aggregator)
    return _scan_result(runner(sched.arrive, sched.dispatch, payload_noise),
                        T, n_clients if wants_init else 0)


def _seed_batch(grad_fn, seeds: Sequence[int], *, n_clients: int,
                n_events: int, beta: float, kappa: float,
                concurrency: Optional[int], local_steps: int, device,
                payload_noise=None) -> List[tuple]:
    """Each seed's ``(arrive, dispatch, payload noise)``: its schedule
    (delays seeded with it) and noise (`payload_noise[i]` where given),
    made before any run."""
    batch = []
    for i, s in enumerate(seeds):
        sched = build_schedule(
            ExponentialDelays(beta=beta, kappa=kappa, n_clients=n_clients,
                              seed=s), n_events, concurrency, seed=s)
        noise = (payload_noise[i] if payload_noise is not None else
                 build_payload_noise(grad_fn, s, n_events, n_clients, 1,
                                     local_steps, device))
        batch.append((sched.arrive, sched.dispatch, noise))
    return batch


def _run_batch(runner, batch, T: int, n_init: int) -> List[ScanResult]:
    """One runner call per seed of `batch` (`_seed_batch`)."""
    return [_scan_result(runner(*args), T, n_init) for args in batch]


def run_scan_seeds(*, grad_fn: Callable, params0, aggregator: Aggregator,
                   n_clients: int, server_lr, T: int,
                   seeds: Sequence[int], beta: float = 5.0,
                   kappa: float = 0.0, n_events: Optional[int] = None,
                   concurrency: Optional[int] = None, local_steps: int = 1,
                   local_lr: float = 0.05, init_cache_grads: bool = True,
                   runner=None, device=None,
                   payload_noise: Optional[Sequence[PayloadNoise]] = None
                   ) -> List[ScanResult]:
    """One `ScanResult` per seed, each equal bit for bit to `run_scan` with
    that seed (delays ``ExponentialDelays(beta, kappa, n_clients, seed)``):
    one runner called once per seed, so the card captures once. Pass
    `runner` (a `make_scan_runner` result for the same rule, T and event
    count) to reuse it across calls; the one built here has the sanitize
    checks off, as the JAX package's sweeps do. ``payload_noise`` takes a
    per-seed list in place of the noise drawn from each seed."""
    device = resolve_device(device)
    if n_events is None:
        n_events = default_n_events(aggregator, T, init_cache_grads)
    if payload_noise is not None and len(payload_noise) != len(seeds):
        raise ValueError(f"{len(payload_noise)} payload_noise entries for "
                         f"{len(seeds)} seeds")
    if runner is None:
        runner = make_scan_runner(
            grad_fn=grad_fn, params0=params0, aggregator=aggregator,
            n_clients=n_clients, server_lr=server_lr, T=T, n_events=n_events,
            local_steps=local_steps, local_lr=local_lr,
            init_cache_grads=init_cache_grads, checkify_invariants=False,
            device=device)
    batch = _seed_batch(grad_fn, seeds, n_clients=n_clients,
                        n_events=n_events, beta=beta, kappa=kappa,
                        concurrency=concurrency, local_steps=local_steps,
                        device=device, payload_noise=payload_noise)
    wants_init = init_cache_grads and wants_cache_init(aggregator)
    return _run_batch(runner, batch, T, n_clients if wants_init else 0)


def sweep(*, grad_fn: Callable, params0, n_clients: int, server_lr, T: int,
          algorithms: Sequence[str] = ("asgd", "fedbuff", "ca2fl", "ace",
                                       "aced"),
          seeds: Sequence[int] = (0,), beta: float = 5.0, kappa: float = 0.0,
          concurrency: Optional[int] = None, buffer_size: int = 10,
          tau_algo: Optional[int] = None, cache_dtype: str = "float32",
          local_steps: int = 1, local_lr: float = 0.05,
          device=None) -> Dict[str, Dict]:
    """Registry-driven multi-algorithm × multi-seed sweep on the event
    engine: one runner per algorithm (sanitize checks off), called once
    per seed, run twice — cold (the capture included) and warm. Returns the
    JAX package's rows: ``algo``, ``seeds``, ``final_loss_mean/std``,
    ``wall_s`` (warm), ``compile_s`` (cold − warm) and ``results``."""
    device = resolve_device(device)
    rows: Dict[str, Dict] = {}
    for name in algorithms:
        kwargs = {}
        if name in ("fedbuff", "ca2fl"):
            kwargs["buffer_size"] = buffer_size
        if name == "aced":
            kwargs["tau_algo"] = (tau_algo if tau_algo is not None
                                  else int(2 * beta))
        if name in ("ace", "ace_direct", "aced"):
            kwargs["cache_dtype"] = cache_dtype
        agg = ALGORITHMS[name](**kwargs)
        n_events = default_n_events(agg, T)
        runner = make_scan_runner(
            grad_fn=grad_fn, params0=params0, aggregator=agg,
            n_clients=n_clients, server_lr=server_lr, T=T, n_events=n_events,
            local_steps=local_steps, local_lr=local_lr,
            checkify_invariants=False, device=device)
        # the schedules and the noise are made outside the timed region
        batch = _seed_batch(grad_fn, seeds, n_clients=n_clients,
                            n_events=n_events, beta=beta, kappa=kappa,
                            concurrency=concurrency, local_steps=local_steps,
                            device=device)
        n_init = n_clients if wants_cache_init(agg) else 0
        t0 = time.perf_counter()
        results = _run_batch(runner, batch, T, n_init)   # cold: the capture
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = _run_batch(runner, batch, T, n_init)   # warm: steady state
        wall = time.perf_counter() - t0
        final_losses = [float(r.losses[-1]) if r.losses.size else float("nan")
                        for r in results]
        rows[name] = {
            "algo": name, "seeds": len(results),
            "final_loss_mean": float(np.mean(final_losses)),
            "final_loss_std": float(np.std(final_losses)),
            "wall_s": wall, "compile_s": max(cold - wall, 0.0),
            "results": results,
        }
    return rows
