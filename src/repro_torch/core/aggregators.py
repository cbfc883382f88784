"""Server aggregation rules of the flat engine — port of the rule zoo of
`repro.core.aggregators` (its `ALGORITHMS` registry, all nine rules):

  * Vanilla ASGD       [Mishchenko et al., 2022]  m = 1, immediate
  * Delay-adaptive ASGD [Koloskova et al., 2022]  m = 1, lr ∝ τ_C/τ for
                                                  stragglers
  * FedBuff            [Nguyen et al., 2022]      buffer M
  * CA²FL              [Wang et al., 2024]        buffer M + cached
                                                  calibration, lazy O(d)
                                                  calibration sum
  * CA²FL direct       (paper Alg. a.3, literal)  re-reduces the (n, d)
                                                  calibration cache per arrival
  * ACE direct         (paper Alg. 1)             mean over all n cached rows
  * ACE incremental    (paper Alg. a.5)           u ← u + (g − dq(C_j))/n, O(d)
  * ACED               (paper Alg. a.1)           bounded-delay active set
                                                  τ_algo, incremental O(d)
                                                  sum + expiry owner-ring
  * ACED direct        (paper Alg. a.1, literal)  masked mean over the whole
                                                  cache (int8: the
                                                  `masked_agg` kernel)

The three direct rules are the O(n·d) references the incremental ones are
held against; they take K = 1 arrivals only (`step_batch` raises).

Every rule is a transition

    step(state, arr) -> (state', update (d,), emit (bool 0-d), lr_scale)

with `torch.where`-gated emission: no Python branching on tensor values and
no host read, so a tick of the engine never waits for the card. `step_batch`
is the K-arrival form. States are dicts of tensors plus one cache (ASGD's
is empty). `init_state` takes `d` as the raveled width (a `FlatCache` and
(d,) running vectors) or as a parameter structure (the tree layout: a
tree cache, and running vectors and payloads shaped like the parameters,
every vector op applied per leaf), as in the JAX package. The cache is
updated **in place** (see `repro_torch.core.cache`); every other state
entry is replaced by a new tensor, never written in place, so an engine
can keep the previous state and select between the two. The fused kernels
(`commit_batch`, the K = 1 `cache_row_update` and `row_delta` swaps,
`masked_agg`) serve the flat layout only, as in the JAX package; a tree
cache takes the op chain, its int8 leaves through the quantize and
dequantize kernels. Under a ``("data", "model")`` mesh the flat cache is a
`BlockedFlatCache` (one rank's block), and the rules reach it only
through the cache's methods, so they run on it unchanged. The server
applies ``w ← w − η · lr_scale · update``. The host simulators call the
rules through `on_arrival` / `on_batch`, which read ``emit`` on the host;
the engines' ticks never do.

``state_dtype`` ("float32" | "bfloat16") is the dtype the running vectors
(FedBuff's and CA²FL's buffers, ACE's u, ACED's sums) are stored in; they
are accumulated in f32 (`_acc`, `_where_sub`, `_astate`). A non-f32 state
keeps `step_batch` off the fused commit kernel, whose sums are f32.

Step contract (as in the JAX package): across the `step` calls a state
actually receives, `arr.t` must be strictly increasing (forward jumps
allowed), because the ACED owner-ring keys one client per t_start value.

``fused_commit`` (None: ``REPRO_NO_FUSED_COMMIT`` decides, default on)
picks the fused commit kernel or the op chain for `step_batch`;
``backend`` is passed to the kernel dispatch (`kernels.ops`): None follows
the tensors' device, "torch" forces the plain versions on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import leaves, tree_map
from repro_torch.core.cache import (DTYPES, FlatCache, broadcast_lanes,
                                    cache_device, cache_mean, cache_n,
                                    cache_row, cache_rows, cache_set_row,
                                    cache_set_row_delta, cache_set_rows_delta,
                                    cache_sum, cache_tensors,
                                    flat_commit_batch, init_flat_cache,
                                    init_tree_cache, row_index)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.backend import resolve_device


class Arrival(NamedTuple):
    client: Any                 # int or 0-d/1-element integer tensor
    payload: torch.Tensor       # (d,) gradient-like descent direction
    t: Any                      # server iteration counter (int or 0-d tensor)
    staleness: Any              # server iterations since the client's model


class ArrivalBatch(NamedTuple):
    """K simultaneous arrivals consumed by ONE server step (`step_batch`).

    `clients` (K,) must be pairwise distinct (the K-batch engine's Gumbel
    top-k sampling guarantees it); `payloads` is (K, d); `valid` (K,) bool
    masks out lanes that must be perfect no-ops on the state."""
    clients: Any                # (K,) integer tensor
    payloads: torch.Tensor      # (K, d)
    t: Any                      # shared server iteration counter
    staleness: Any              # (K,)
    valid: torch.Tensor         # (K,) bool


def wants_cache_init(agg) -> bool:
    """Rules seeded with one gradient per client before the loop (paper
    Alg. 1 line 1) declare ``cache_init = True``."""
    return bool(getattr(agg, "cache_init", False))


def _int(x, device) -> torch.Tensor:
    """A 0-d int32 tensor on `device` (the JAX package's traced int32)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(())


def _acc(a, x):
    """``a + x`` per leaf, accumulated in f32 and stored in `a`'s dtype (the
    state dtype; an identity cast for f32 states)."""
    return tree_map(lambda a_, x_: (a_.float() + x_.float()).to(a_.dtype),
                    a, x)


def _gate(emit, new, old):
    """Per-leaf ``where(emit, new, old)``; `new` may be a number (0.0: the
    flush of a buffer)."""
    if isinstance(new, (int, float)):
        return tree_map(lambda o_: torch.where(emit, new, o_), old)
    return tree_map(lambda n_, o_: torch.where(emit, n_, o_), new, old)


def _where_sub(a, x, gate):
    """Per-leaf ``a − x`` where `gate` else ``a``, accumulated in f32 and
    stored in `a`'s dtype — the expiry primitive of the running-sum
    rules."""
    return tree_map(lambda a_, x_: torch.where(
        gate, a_.float() - x_.float(), a_.float()).to(a_.dtype), a, x)


def _astate(vec, dtype: str):
    """A running vector (or structure of them) cast to the rule's state
    dtype."""
    return tree_map(lambda v: v.to(DTYPES[dtype]), vec)


def _device(tree) -> torch.device:
    """The device of a tensor or of a structure's first leaf."""
    return leaves(tree)[0].device


_CONSTANTS = {}


def _constant(key, device, make) -> torch.Tensor:
    """A constant tensor of the rules, made by `make()` once per `key` and
    device and only ever read: a tick launches no fill for it, and a
    captured tick copies no host value into it."""
    t = _CONSTANTS.get((key, device))
    if t is None:
        t = _CONSTANTS[key, device] = make()
    return t


def _true(device) -> torch.Tensor:
    """A 0-d True on `device` (an ``emit`` the engine only reads: ``emit &
    ...`` makes a new tensor)."""
    return _constant("true", device, lambda: torch.ones(
        (), dtype=torch.bool, device=device))


# `init_state` takes `d` as the raveled width (an int: the flat layout, a
# `FlatCache` and (d,) running vectors) or as a parameter structure, the
# template of the tree layout (a tree cache, and running vectors shaped
# like the parameters), as in the JAX package.

def _is_template(d) -> bool:
    return not isinstance(d, (int, np.integer))


def _init_cache(n, d, dtype, init_grads, device, backend):
    if _is_template(d):
        return init_tree_cache(n, d, dtype, init_grads, device, backend)
    return init_flat_cache(n, int(d), dtype, init_grads, device, backend)


def _zeros_vec(d, dtype: str, device):
    if _is_template(d):
        return tree_map(lambda g: torch.zeros(tuple(g.shape),
                                              dtype=DTYPES[dtype],
                                              device=device), d)
    return torch.zeros((int(d),), dtype=DTYPES[dtype], device=device)


def _masked_batch_sum(rows, mask):
    """Per-leaf ``Σ_{k : mask[k]} rows[k]`` over the leading (K,) lane axis
    in f32, `where`-gated: a quarantined lane's payload may be NaN/inf, and
    ``NaN · 0`` would poison the sum."""
    return tree_map(lambda p: torch.where(
        broadcast_lanes(mask, p), p.float(), 0.0).sum(0), rows)


def _sum_lanes(tree):
    """Per-leaf f32 sum over the leading (K,) lane axis (unmasked: the
    deltas of `cache_set_rows_delta` are already zero on invalid lanes)."""
    return tree_map(lambda x: x.float().sum(0), tree)


def _scaled(tree, s):
    """Per-leaf ``x · s`` in f32 (`s` a scalar or a 0-d tensor)."""
    return tree_map(lambda x: x.float() * s, tree)


def _inv_count(count):
    """``1 / max(count, 1)`` in f32 (IEEE reciprocal)."""
    return torch.clamp(count, min=1).float().reciprocal()


def _batch_mean_inv(valid):
    """``1 / n_valid`` where a lane is valid, else 0 (FedAsync's burst
    average over the valid lanes)."""
    nv = valid.float().sum()
    return torch.where(nv > 0, torch.clamp(nv, min=1.0).reciprocal(), 0.0)


def _fused_flat_commit(flag, cache, vecs) -> bool:
    """The fused K-arrival commit is taken only on the flat layout (a tree
    cache keeps the op chain, as in the JAX package), when every carried
    running vector is f32 (the kernel's accumulation dtype — non-f32
    `state_dtype` rules stay on the op chain) and the wiring is enabled
    (`fused_commit` field / ``REPRO_NO_FUSED_COMMIT``)."""
    return (isinstance(cache, FlatCache)
            and all(v.dtype == torch.float32 for v in vecs)
            and kernel_ops.fused_commit_enabled(flag))


class Aggregator:
    """Base: subclasses define init_state / step / step_batch."""
    name = "base"
    #: whether every buffer flush is certain to emit; a rule whose emission
    #: is data-dependent and refusable sets this False, so the engines
    #: budget extra events (`scan_engine.default_n_events`)
    guaranteed_emit = True

    def init_state(self, n: int, d, init_grads=None, device=None):
        """Initial server state for n clients. `d` is the raveled width (an
        int: a `FlatCache` and (d,) running vectors) or a parameter
        structure (the tree layout: a tree cache and running vectors shaped
        like it); `init_grads` matches, an (n, d) tensor or a structure
        whose leaves lead with (n,), for the cache-init rules."""
        raise NotImplementedError

    def step(self, state, arr: Arrival):
        """-> (state, update (d,), emit (0-d bool), lr_scale)."""
        raise NotImplementedError

    def on_arrival(self, state, arr: Arrival):
        """Host wrapper over `step` for the host simulators -> (state,
        update (d,) or None, lr_scale float). It reads ``emit`` on the host
        (one sync), so an engine's tick never calls it."""
        state, update, emit, lr_scale = self.step(state, arr)
        return state, (update if bool(emit) else None), float(lr_scale)

    def step_batch(self, state, batch: ArrivalBatch):
        """K-arrival transition: one aggregation and one emission decision
        for the whole batch; invalid lanes are perfect no-ops, and a batch
        with no valid lane leaves the cache unchanged."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support K-batched arrivals")

    def on_batch(self, state, batch: ArrivalBatch):
        """Host wrapper over `step_batch` (the mirror of `on_arrival`)."""
        state, update, emit, lr_scale = self.step_batch(state, batch)
        return state, (update if bool(emit) else None), float(lr_scale)

    def resync(self, state):
        """Exact self-heal: re-derive every incrementally maintained running
        aggregate from the per-client cache. O(n·d); rules without running
        sums return the state unchanged."""
        return state

    def nbytes(self, state) -> int:
        """Bytes of every tensor of `state`: a cache's codes and scales and
        the running vectors and counters, in either layout."""
        return sum(x.numel() * x.element_size() for v in state.values()
                   for x in (cache_tensors(v) or leaves(v)))


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VanillaASGD(Aggregator):
    """Every arrival is applied at once (m = 1). The state is empty."""
    name = "asgd"

    def init_state(self, n, d, init_grads=None, device=None):
        return {}

    def step(self, state, arr):
        true = torch.ones((), dtype=torch.bool, device=_device(arr.payload))
        return state, arr.payload, true, 1.0

    def step_batch(self, state, batch):
        # FedAsync's burst rule: average the simultaneously received
        # contributions into one server step
        update = _scaled(_masked_batch_sum(batch.payloads, batch.valid),
                         _batch_mean_inv(batch.valid))
        return state, update, batch.valid.any(), 1.0


def _delay_scale(staleness, tau_c: float, device):
    """``1`` if τ ≤ τ_C else ``τ_C / max(τ, 1)``, per lane, in f32 (a true
    division: a Python number over a tensor would be a reciprocal
    multiply)."""
    tau = torch.clamp(torch.as_tensor(staleness, device=device).float(),
                      min=0.0)
    tau_c_t = torch.full_like(tau, tau_c)
    return torch.where(tau <= tau_c, 1.0, tau_c_t / torch.clamp(tau, min=1.0))


@dataclasses.dataclass
class DelayAdaptiveASGD(Aggregator):
    """η_t = η if τ ≤ τ_C else η·τ_C/τ (down-weight stale gradients)."""
    tau_c: float = 10.0
    name = "delay_asgd"

    def init_state(self, n, d, init_grads=None, device=None):
        return {}

    def step(self, state, arr):
        dev = _device(arr.payload)
        scale = _delay_scale(arr.staleness, self.tau_c, dev).reshape(())
        true = torch.ones((), dtype=torch.bool, device=dev)
        return state, arr.payload, true, scale

    def step_batch(self, state, batch):
        # the per-lane discounts fold INTO the averaged update (one scalar
        # lr_scale cannot carry K weights), so lr_scale = 1 here
        scale = _delay_scale(batch.staleness, self.tau_c,
                             _device(batch.payloads)).reshape(-1)
        scaled = tree_map(lambda p: p.float() * broadcast_lanes(scale, p),
                          batch.payloads)
        update = _scaled(_masked_batch_sum(scaled, batch.valid),
                         _batch_mean_inv(batch.valid))
        return state, update, batch.valid.any(), 1.0


@dataclasses.dataclass
class FedBuff(Aggregator):
    """Buffer M arrivals, then apply their mean."""
    buffer_size: int = 10
    state_dtype: str = "float32"
    name = "fedbuff"

    def init_state(self, n, d, init_grads=None, device=None):
        device = resolve_device(device)
        return {"accum": _zeros_vec(d, self.state_dtype, device),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _flush(self, accum, count, inv):
        # emit-gated reciprocal: a buffered (non-flushing) arrival's
        # "update" is a multiply by 0, not an O(d) divide
        emit = count >= self.buffer_size
        inv = torch.where(emit, inv, 0.0)
        update = _scaled(accum, inv)
        return ({"accum": _gate(emit, 0.0, accum),
                 "count": torch.where(emit, 0, count)}, update, emit, 1.0)

    def step(self, state, arr):
        accum = _acc(state["accum"], arr.payload)
        count = state["count"] + 1
        return self._flush(accum, count, count.float().reciprocal())

    def step_batch(self, state, batch):
        # the buffer may overshoot `buffer_size` when a batch straddles the
        # flush; dividing by the achieved count keeps the flush an exact
        # mean of everything buffered
        accum = _acc(state["accum"],
                     _masked_batch_sum(batch.payloads, batch.valid))
        count = state["count"] + batch.valid.sum(dtype=torch.int32)
        return self._flush(accum, count, _inv_count(count))


@dataclasses.dataclass
class CA2FL(Aggregator):
    """Cache-aided calibration: v = h̄ + Σ_{i∈S}(Δ_i − h_i)/m (paper Alg. a.3)
    with a lazy calibration mean — O(d) per arrival.

    The per-client calibration cache h is a `FlatCache` (int8 applies to it
    like to ACE's); h_i⁰ = 0 per Alg. a.3. The running sum
    ``h_sum = Σ_i dq(h_i)`` is kept through the row swap
    (``h_sum += dq(new) − dq(old)``, exact under int8), and
    ``h̄ = h_sum/n`` folds into the emit-gated refresh only."""
    buffer_size: int = 10
    cache_dtype: str = "float32"
    state_dtype: str = "float32"
    fused_commit: Optional[bool] = None
    backend: Optional[str] = None
    name = "ca2fl"

    def init_state(self, n, d, init_grads=None, device=None):
        h = _init_cache(n, d, self.cache_dtype, init_grads, device,
                        self.backend)
        mean = cache_mean(h, backend=self.backend)
        dev = cache_device(h)
        return {"h": h, "h_bar": _astate(mean, self.state_dtype),
                "h_sum": _astate(tree_map(lambda m: m * n, mean),
                                 self.state_dtype),
                "accum": _zeros_vec(d, self.state_dtype, dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def _emit(self, count):
        emit = count >= self.buffer_size
        inv = torch.where(emit, _inv_count(count), 0.0)
        return emit, inv

    def _refresh(self, state, h, accum, h_sum, count):
        """The emit-gated tail shared by the op-chain forms: the update and
        the lazy h̄ = h_sum/n refresh."""
        emit, inv = self._emit(count)
        g, inv_n = emit.float(), 1.0 / cache_n(h)
        update = tree_map(lambda hb, a: hb.float() * g + a.float() * inv,
                          state["h_bar"], accum)
        h_bar = tree_map(lambda hb, hs: torch.where(
            emit, hs.float() * inv_n, hb.float()).to(hb.dtype),
            state["h_bar"], h_sum)
        new_state = {"h": h, "h_bar": h_bar, "h_sum": h_sum,
                     "accum": _gate(emit, 0.0, accum),
                     "count": torch.where(emit, 0, count)}
        return new_state, update, emit, 1.0

    def step(self, state, arr):
        j = row_index(arr.client, cache_device(state["h"]))
        h, delta, old = cache_set_row_delta(state["h"], j, arr.payload,
                                            backend=self.backend)
        accum = _acc(state["accum"], tree_map(lambda g, o: g.float() - o,
                                              arr.payload, old))
        h_sum = _acc(state["h_sum"], delta)
        return self._refresh(state, h, accum, h_sum, state["count"] + 1)

    def step_batch(self, state, batch):
        h = state["h"]
        js = row_index(batch.clients, cache_device(h))
        valid = batch.valid
        count = state["count"] + valid.sum(dtype=torch.int32)
        vecs = (state["accum"], state["h_sum"], state["h_bar"])
        if _fused_flat_commit(self.fused_commit, h, vecs):
            # fused commit, basis [accum, h_sum, h_bar, S_Δ, S_A, S_B, S_G]
            # with lane_a = lane_g = valid (S_G − S_A = Σ_valid(g − old)):
            #   accum' = (1−g)·(accum + S_G − S_A)
            #   h_sum' = h_sum + S_Δ
            #   h_bar' = g·inv_n·h_sum' + (1−g)·h_bar
            #   update = g·h_bar + inv·(accum + S_G − S_A)
            emit, inv = self._emit(count)
            inv_n = 1.0 / cache_n(h)
            g = emit.float()
            one, zero = torch.ones_like(g), torch.zeros_like(g)
            keep = 1.0 - g
            coef = torch.stack([
                torch.stack([keep, zero, zero, zero, -keep, zero, keep]),
                torch.stack([zero, one, zero, one, zero, zero, zero]),
                torch.stack([zero, g * inv_n, keep, g * inv_n,
                             zero, zero, zero])])
            upd_w = torch.stack([inv, zero, g, zero, -inv, zero, inv])
            vf = valid.float()
            h, out, update = flat_commit_batch(
                h, js, batch.payloads, valid, torch.stack(vecs), coef, upd_w,
                lane_a=vf, lane_g=vf, backend=self.backend)
            new_state = {"h": h, "h_bar": out[2], "h_sum": out[1],
                         "accum": out[0],
                         "count": torch.where(emit, 0, count)}
            return new_state, update, emit, 1.0
        h, delta, old = cache_set_rows_delta(h, js, batch.payloads, valid,
                                             self.backend)
        accum = _acc(state["accum"], _masked_batch_sum(
            tree_map(lambda g, o: g.float() - o, batch.payloads, old),
            valid))
        h_sum = _acc(state["h_sum"], _sum_lanes(delta))
        return self._refresh(state, h, accum, h_sum, count)

    def resync(self, state):
        return {**state, "h_sum": _astate(
            cache_sum(state["h"], backend=self.backend), self.state_dtype)}


@dataclasses.dataclass
class CA2FLDirect(Aggregator):
    """Paper Alg. a.3, literal: re-reduces ``cache_mean(h)`` over the whole
    (n, d) calibration cache on every arrival — the O(n·d) reference the
    lazy `CA2FL` is held against. K = 1 only."""
    buffer_size: int = 10
    cache_dtype: str = "float32"
    state_dtype: str = "float32"
    backend: Optional[str] = None
    name = "ca2fl_direct"

    def init_state(self, n, d, init_grads=None, device=None):
        h = _init_cache(n, d, self.cache_dtype, init_grads, device,
                        self.backend)
        dev = cache_device(h)
        return {"h": h,
                "h_bar": _astate(cache_mean(h, backend=self.backend),
                                 self.state_dtype),
                "accum": _zeros_vec(d, self.state_dtype, dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(self, state, arr):
        h = state["h"]
        j = row_index(arr.client, cache_device(h))
        # read the old row before the write: the cache is updated in place
        old = cache_row(h, j, backend=self.backend)
        accum = _acc(state["accum"], tree_map(lambda g, o: g.float() - o,
                                              arr.payload, old))
        h = cache_set_row(h, j, arr.payload, backend=self.backend)
        count = state["count"] + 1
        emit = count >= self.buffer_size
        cf = count.float()
        update = tree_map(lambda hb, a: hb.float() + a.float() / cf,
                          state["h_bar"], accum)
        h_bar = tree_map(lambda hb, hm: torch.where(
            emit, hm, hb.float()).to(hb.dtype), state["h_bar"],
            cache_mean(h, backend=self.backend))
        new_state = {"h": h, "h_bar": h_bar,
                     "accum": _gate(emit, 0.0, accum),
                     "count": torch.where(emit, 0, count)}
        return new_state, update, emit, 1.0


@dataclasses.dataclass
class ACEDirect(Aggregator):
    """Paper Algorithm 1: cache row j ← g, update = mean over all n rows.
    K = 1 only."""
    cache_dtype: str = "float32"
    backend: Optional[str] = None
    name = "ace_direct"
    cache_init = True

    def init_state(self, n, d, init_grads=None, device=None):
        return {"cache": _init_cache(n, d, self.cache_dtype, init_grads,
                                     device, self.backend)}

    def step(self, state, arr):
        cache = cache_set_row(state["cache"], arr.client, arr.payload,
                              backend=self.backend)
        true = torch.ones((), dtype=torch.bool, device=cache_device(cache))
        return ({"cache": cache}, cache_mean(cache, backend=self.backend),
                true, 1.0)


@dataclasses.dataclass
class ACEIncremental(Aggregator):
    """Paper Algorithm a.5: u ← u + (g − dq(C_j))/n — O(d) per arrival.

    Exact under an int8 cache: the subtracted value is the dequantized row
    that was previously added, so ``u == mean_i dq(C_i)`` is invariant. The
    K = 1 int8 step is one `cache_row_update` launch (the new scale, the
    row swap and u'); the K-arrival step goes through the fused commit
    kernel."""
    cache_dtype: str = "float32"
    state_dtype: str = "float32"
    fused_commit: Optional[bool] = None
    backend: Optional[str] = None
    name = "ace"
    cache_init = True

    def init_state(self, n, d, init_grads=None, device=None):
        cache = _init_cache(n, d, self.cache_dtype, init_grads, device,
                            self.backend)
        return {"cache": cache,
                "u": _astate(cache_mean(cache, backend=self.backend),
                             self.state_dtype)}

    def step(self, state, arr):
        cache, u = state["cache"], state["u"]
        dev = cache_device(cache)
        j = row_index(arr.client, dev)
        true = _true(dev)
        if isinstance(cache, FlatCache) and cache.quantized:
            # one launch: the new scale, the row swap in place and a fresh
            # u' (added in f32, stored in the state dtype); u is not written
            u = cache.set_row_ace(j, arr.payload, u, 1.0 / cache.n,
                                  backend=self.backend)
            return {"cache": cache, "u": u}, u, true, 1.0
        n = cache_n(cache)
        old = cache_row(cache, j, self.backend)
        cache = cache_set_row(cache, j, arr.payload, self.backend)
        new = cache_row(cache, j, self.backend)
        u = tree_map(lambda u_, nw, od: (u_.float() + (nw - od) / n
                                         ).to(u_.dtype), u, new, old)
        return {"cache": cache, "u": u}, u, true, 1.0

    def step_batch(self, state, batch):
        # Batched Alg. a.5: u += Σ_k (dq(new_k) − dq(old_k))/n in one O(K·d)
        # pass — the fused commit kernel (basis [u, S_Δ, ...]:
        # u' = u + S_Δ/n), or the op chain.
        cache = state["cache"]
        dev = cache_device(cache)
        js = row_index(batch.clients, dev)
        n = cache_n(cache)
        emit = batch.valid.any()
        if _fused_flat_commit(self.fused_commit, cache, (state["u"],)):
            coef = _constant(("ace_coef", n), dev, lambda: torch.tensor(
                [[1.0, 1.0 / n, 0.0, 0.0, 0.0]], dtype=torch.float32,
                device=dev))
            cache, _, u = flat_commit_batch(
                cache, js, batch.payloads, batch.valid, state["u"][None],
                coef, coef[0], backend=self.backend)
            return {"cache": cache, "u": u}, u, emit, 1.0
        cache, delta, _ = cache_set_rows_delta(cache, js, batch.payloads,
                                               batch.valid, self.backend)
        u = tree_map(lambda u_, d_: (u_.float() + d_ / n).to(u_.dtype),
                     state["u"], _sum_lanes(delta))
        return {"cache": cache, "u": u}, u, emit, 1.0

    def resync(self, state):
        return {**state, "u": _astate(
            cache_mean(state["cache"], backend=self.backend),
            self.state_dtype)}


#: the most bytes of dequantized cache rows one gather of ACED's cohort
#: sweep forms (a real model's row is gigabytes: one slot at a time)
SWEEP_BYTES = 1 << 30


@dataclasses.dataclass
class ACED(Aggregator):
    """Paper Algorithm a.1 with an incremental active-set sum — O(d) per
    event (the ACE-incremental pattern extended to the bounded-delay active
    set A(t) = {i : t − t_start_i ≤ τ_algo}).

    State beyond the cache:
      * ``asum (d,)`` / ``count`` — running Σ_{i∈A} dq(C_i) and |A|.
      * ``ring`` — the owner-ring keyed on ``t_start mod P``, P = τ_algo+2:
        (P,) for K = 1, (P, max_cohort) when a slot owns a cohort of up to
        max_cohort clients sharing one t_start (K-arrival ticks). Each step
        retires the slots whose t_start fell to ≤ t−τ_algo−1; an
        availability-window thaw jump of Δt retires min(Δt, P) slots.
      * ``init_sum``/``init_count``/``init_mask`` — the init batch (all n
        clients share t_start = 1), subtracted in one where-gated O(d)
        correction when t first reaches τ_algo+2.
      * ``t_prev`` — last processed arrival time, bounding the sweep.

    The JAX package's expiry sweep is a `fori_loop` with a traced trip count
    Δt; here every one of the P slots is visited, masked by ``slot < Δt``,
    so the count never has to be read on the host. The slots are disjoint,
    and an unvisited slot subtracts an exact zero, so the masked sweep
    retires exactly the owners the loop would, in the loop's order."""
    tau_algo: int = 10
    cache_dtype: str = "float32"
    state_dtype: str = "float32"
    #: owner-ring cohort width (= the engine's K); 1 keeps the (P,) ring
    max_cohort: int = 1
    fused_commit: Optional[bool] = None
    backend: Optional[str] = None
    name = "aced"
    cache_init = True

    @property
    def ring_size(self) -> int:
        return self.tau_algo + 2

    def init_state(self, n, d, init_grads=None, device=None):
        cache = _init_cache(n, d, self.cache_dtype, init_grads, device,
                            self.backend)
        dev = cache_device(cache)
        ring_shape = ((self.ring_size,) if self.max_cohort == 1
                      else (self.ring_size, self.max_cohort))
        asum = _astate(cache_sum(cache, backend=self.backend),
                       self.state_dtype)
        return {"cache": cache,
                "t_start": torch.ones((n,), dtype=torch.int32, device=dev),
                "ring": torch.full(ring_shape, -1, dtype=torch.int32,
                                   device=dev),
                "asum": asum,
                "count": torch.full((), n, dtype=torch.int32, device=dev),
                "t_prev": torch.zeros((), dtype=torch.int32, device=dev),
                "init_sum": asum,
                "init_count": torch.full((), n, dtype=torch.int32,
                                         device=dev),
                "init_mask": torch.ones((n,), dtype=torch.bool, device=dev)}

    def _sweep(self, state, asum, t, first_slot):
        """Expiry sweep over ring slots ``first_slot..P-1``: slot i holds
        the owners with t_start ≡ t−τ−1−i (mod P); it is visited when
        i < Δt and retires each owner whose t_start ≤ t−τ−1. Each slot's
        retired rows (one sum over its cohort) leave `asum` in slot order,
        where-gated, as the iterations of the JAX loop do. Returns
        ``(asum', n_dead, ring')``; the rows are read from the pre-arrival
        cache."""
        cache, ring = state["cache"], state["ring"]
        P, tau = self.ring_size, self.tau_algo
        dev = ring.device
        dt = torch.clamp(t - state["t_prev"], 0, P)
        i = torch.arange(first_slot, P, dtype=torch.int32, device=dev)
        s = torch.remainder(t - tau - 1 - i, P).long()
        owners = ring.index_select(0, s)
        # rows are gathered at the owners clamped into [0, n−1]: a corrupted
        # slot reads a real row (JAX's gather clamps too) and never faults,
        # and the sanitize ring check reports it; `owners >= 0` marks a
        # full slot
        ow = torch.clamp(owners, 0, state["t_start"].shape[0] - 1).long()
        visit = (i < dt).reshape((-1,) + (1,) * (owners.dim() - 1))
        gone = visit & (owners >= 0) & (state["t_start"][ow] <= t - tau - 1)
        if owners.dim() == 2:
            # a cohort per slot: its retired lanes summed; the slots' rows
            # are dequantized as many slots at a time as keep them within
            # `SWEEP_BYTES` (all at once at the vision and text tasks'
            # widths, one slot — JAX's loop — at a real model's)
            C = owners.shape[1]
            row_bytes = 4 * sum(x.numel() for x in cache_tensors(cache)) \
                // cache_n(cache)
            step = max(1, SWEEP_BYTES // (C * row_bytes))
            for a in range(0, owners.shape[0], step):
                g = gone[a:a + step]
                rows = cache_rows(cache, ow[a:a + step].reshape(-1),
                                  backend=self.backend)
                rows = tree_map(lambda r: torch.where(
                    broadcast_lanes(g.reshape(-1), r), r, 0.0).reshape(
                        g.shape + r.shape[1:]).sum(1), rows)
                slot_gone = g.any(1)
                for k in range(g.shape[0]):
                    asum = _where_sub(asum, tree_map(lambda r: r[k], rows),
                                      slot_gone[k])
        else:
            rows = cache_rows(cache, ow, backend=self.backend)
            for k in range(owners.shape[0]):
                asum = _where_sub(asum, tree_map(lambda r: r[k], rows),
                                  gone[k])
        ring = ring.index_copy(0, s, torch.where(gone, -1, owners))
        return asum, gone.sum(dtype=torch.int32), ring

    def _fire(self, state, t, count):
        """Init-batch one-shot expiry at t = τ_algo+2 (also when a jump
        leaps past it): scalar bookkeeping, the O(d) correction is the
        caller's."""
        init_count = state["init_count"]
        fire = (init_count > 0) & (t >= self.tau_algo + 2)
        count = count - torch.where(fire, init_count, 0)
        init_count = torch.where(fire, 0, init_count)
        init_mask = state["init_mask"] & ~fire
        return fire, count, init_count, init_mask

    def step(self, state, arr):
        cache = state["cache"]
        dev = cache_device(cache)
        if self.max_cohort > 1:
            # the (P, max_cohort) ring speaks cohorts — route single
            # arrivals through the batched transition as a 1-lane batch
            return self.step_batch(state, ArrivalBatch(
                clients=row_index(arr.client, dev),
                payloads=tree_map(lambda g: g[None], arr.payload),
                t=arr.t, staleness=row_index(arr.staleness, dev),
                valid=torch.ones((1,), dtype=torch.bool, device=dev)))
        j = row_index(arr.client, dev)
        t = _int(arr.t, dev)
        tau, P = self.tau_algo, self.ring_size
        t_start, ring = state["t_start"], state["ring"]

        # 1. expiry: slot 0 (the slot whose t_start fell to t−τ−1, ≤ 1 per
        # ordinary step — its O(d) subtraction rides the fused asum
        # expression below), then the thaw-jump slots 1..P-1
        dt = torch.clamp(t - state["t_prev"], 0, P)
        s0 = torch.remainder(t - tau - 1, P).long().reshape(1)
        k0 = ring.index_select(0, s0)
        k0c = torch.clamp(k0, 0, t_start.shape[0] - 1).long()
        dead = (dt >= 1) & (k0 >= 0) & (t_start[k0c] <= t - tau - 1)
        dead_row = cache_row(cache, k0c, backend=self.backend)
        ring = ring.index_copy(0, s0, torch.where(dead, -1, k0))
        asum, n_jump, ring = self._sweep({**state, "ring": ring},
                                         state["asum"], t, 1)
        count = state["count"] - dead[0].int() - n_jump

        # 2. init-batch one-shot
        fire, count, init_count, init_mask = self._fire(state, t, count)

        # 3. arrival: swap row j in. One fused O(d) expression updates the
        # active sum with the slot-0 expiry, the init correction and the
        # swap: an active client contributes its delta, a returning one its
        # whole new row.
        old_ts = t_start[j]
        was_active = old_ts >= t - tau
        was_init = init_mask[j]
        cache, delta, old = cache_set_row_delta(cache, j, arr.payload,
                                                backend=self.backend)
        g_dead = dead.float()
        g_fire = fire.float()
        g_ret = 1.0 - was_active.float()
        init_sum = state["init_sum"]
        asum = tree_map(
            lambda a, r_, i_, d_, o: (a.float() - g_dead * r_
                                      - g_fire * i_.float() + d_ + g_ret * o
                                      ).to(a.dtype),
            asum, dead_row, init_sum, delta, old)
        count = count + 1 - was_active[0].int()
        g_wi = was_init.float()
        init_sum = tree_map(lambda i_, o: ((1.0 - g_fire) * i_.float()
                                           - g_wi * o).to(i_.dtype),
                            init_sum, old)
        init_count = init_count - was_init[0].int()
        init_mask = init_mask.index_copy(
            0, j, torch.zeros((1,), dtype=torch.bool, device=dev))

        # 4. ring ownership: disown j's previous slot, then own (t+1) mod P
        s_old = torch.remainder(old_ts, P).long()
        cur = ring.index_select(0, s_old)
        ring = ring.index_copy(0, s_old, torch.where(cur == j, -1, cur))
        ring = ring.index_copy(0, torch.remainder(t + 1, P).long().reshape(1),
                               j.int())
        t_start = t_start.index_copy(0, j, (t + 1).reshape(1))

        update = _scaled(asum, _inv_count(count))
        new_state = {"cache": cache, "t_start": t_start, "ring": ring,
                     "asum": asum, "count": count, "t_prev": t,
                     "init_sum": init_sum, "init_count": init_count,
                     "init_mask": init_mask}
        return new_state, update, count > 0, 1.0

    def step_batch(self, state, batch):
        """K simultaneous arrivals sharing one t (one t_start = t+1 cohort).
        Requires ``max_cohort ≥ K``: the ring row at ``(t+1) mod P`` owns the
        whole cohort, and every expiry retires a slot's entire cohort."""
        cache = state["cache"]
        dev = cache_device(cache)
        js = row_index(batch.clients, dev)
        K = js.shape[0]
        if self.max_cohort < max(K, 2):
            raise ValueError(
                f"ACED(max_cohort={self.max_cohort}) cannot own a "
                f"{K}-arrival cohort — construct with max_cohort >= "
                "max(K, 2) (the cohort ring is (P, max_cohort))")
        t = _int(batch.t, dev)
        valid = batch.valid
        tau, P, C = self.tau_algo, self.ring_size, self.max_cohort

        # 1. expiry sweep over all P slots, masked by slot < Δt
        asum, n_dead, ring = self._sweep(state, state["asum"], t, 0)
        count = state["count"] - n_dead

        # 2. init-batch one-shot (identical to the K=1 rule)
        fire, count, init_count, init_mask = self._fire(state, t, count)
        g_fire = fire.float()

        # 3. cohort swap-in: returning (valid, not active) lanes add their
        # whole old rows, active lanes their deltas; invalid lanes are
        # bit-exact no-ops on the cache and zero in every sum
        t_start = state["t_start"]
        old_ts = t_start[js]
        was_active = old_ts >= t - tau
        was_init = init_mask[js] & valid
        ret = valid & ~was_active
        count = count + ret.sum(dtype=torch.int32)
        inv = _inv_count(count)
        init_sum = state["init_sum"]
        if _fused_flat_commit(self.fused_commit, cache, (asum, init_sum)):
            # basis [asum, init_sum, S_Δ, S_A, S_B, S_G], lane_a = ret,
            # lane_b = was_init:
            #   asum'     = asum − g_fire·init_sum + S_Δ + S_A
            #   init_sum' = (1−g_fire)·init_sum − S_B
            #   update    = inv·(that same asum' row)
            one, zero = torch.ones_like(g_fire), torch.zeros_like(g_fire)
            r_asum = torch.stack([one, -g_fire, one, one, zero, zero])
            coef = torch.stack([
                r_asum,
                torch.stack([zero, 1.0 - g_fire, zero, zero, -one, zero])])
            cache, out, update = flat_commit_batch(
                cache, js, batch.payloads, valid,
                torch.stack((asum, init_sum)), coef, inv * r_asum,
                lane_a=ret.float(), lane_b=was_init.float(),
                backend=self.backend)
            asum, init_sum = out[0], out[1]
        else:
            cache, delta, old = cache_set_rows_delta(
                cache, js, batch.payloads, valid, self.backend)
            asum = tree_map(
                lambda a, i_, d_, r_: (a.float() - g_fire * i_.float() + d_
                                       + r_).to(a.dtype),
                asum, init_sum, _sum_lanes(delta),
                _masked_batch_sum(old, ret))
            init_sum = tree_map(
                lambda i_, w_: ((1.0 - g_fire) * i_.float() - w_
                                ).to(i_.dtype),
                init_sum, _masked_batch_sum(old, was_init))
            update = _scaled(asum, inv)
        init_count = init_count - was_init.sum(dtype=torch.int32)
        init_mask = init_mask.index_copy(0, js, init_mask[js] & ~valid)
        t_start = t_start.index_copy(
            0, js, torch.where(valid, t + 1, old_ts).int())

        # 4. ring ownership: disown every valid lane's previous slot entry
        # anywhere in the ring, then claim slot (t+1) mod P with the cohort
        # (that slot aliases (t−τ−1) mod P, which the sweep just emptied)
        hit = ((ring[..., None] == js) & valid).any(-1)
        ring = torch.where(hit, -1, ring)
        cohort = torch.full((C,), -1, dtype=torch.int32, device=dev)
        cohort[:K] = torch.where(valid, js, -1)
        ring = ring.index_copy(0, torch.remainder(t + 1, P).long().reshape(1),
                               cohort[None])

        new_state = {"cache": cache, "t_start": t_start, "ring": ring,
                     "asum": asum, "count": count, "t_prev": t,
                     "init_sum": init_sum, "init_count": init_count,
                     "init_mask": init_mask}
        return new_state, update, count > 0, 1.0

    def resync(self, state):
        """Recompute asum/count and the init-cohort state from the cache:
        the active set after the step at t_prev is
        {i : t_prev − t_start_i ≤ τ_algo}."""
        cache, t_start = state["cache"], state["t_start"]
        active = (state["t_prev"] - t_start) <= self.tau_algo
        init_mask = state["init_mask"]
        return {**state,
                "asum": _astate(cache_sum(cache, active, self.backend),
                                self.state_dtype),
                "count": active.sum(dtype=torch.int32),
                "init_sum": _astate(cache_sum(cache, init_mask, self.backend),
                                    self.state_dtype),
                "init_count": init_mask.sum(dtype=torch.int32)}


@dataclasses.dataclass
class ACEDDirect(Aggregator):
    """Paper Algorithm a.1, literal: masked mean over the whole (n, d) cache
    on every arrival — the O(n·d) reference the incremental `ACED` is held
    against. On an int8 cache the masked mean is the `masked_agg` kernel.
    K = 1 only."""
    tau_algo: int = 10
    cache_dtype: str = "float32"
    backend: Optional[str] = None
    name = "aced_direct"
    cache_init = True

    def init_state(self, n, d, init_grads=None, device=None):
        cache = _init_cache(n, d, self.cache_dtype, init_grads, device,
                            self.backend)
        return {"cache": cache,
                "t_start": torch.ones((n,), dtype=torch.int32,
                                      device=cache_device(cache))}

    def step(self, state, arr):
        cache = state["cache"]
        dev = cache_device(cache)
        j = row_index(arr.client, dev)
        cache = cache_set_row(cache, j, arr.payload, backend=self.backend)
        t = _int(arr.t, dev)
        t_start = state["t_start"].index_copy(0, j, (t + 1).reshape(1))
        active = (t - t_start) <= self.tau_algo
        if isinstance(cache, FlatCache) and cache.quantized:
            update = cache.masked_agg(active, backend=self.backend)
        else:
            update = cache_mean(cache, active, backend=self.backend)
        return ({"cache": cache, "t_start": t_start}, update, active.any(),
                1.0)


ALGORITHMS = {
    "asgd": VanillaASGD,
    "delay_asgd": DelayAdaptiveASGD,
    "fedbuff": FedBuff,
    "ca2fl": CA2FL,
    "ca2fl_direct": CA2FLDirect,
    "ace_direct": ACEDirect,
    "ace": ACEIncremental,
    "aced": ACED,
    "aced_direct": ACEDDirect,
}


def make_aggregator(cfg) -> Aggregator:
    """Build any rule of `ALGORITHMS` from an object with the fields of
    `repro.configs.AFLConfig` (``algorithm``, ``cache_dtype``,
    ``state_dtype`` (default "float32"), ``buffer_size``, ``tau_algo``,
    ``k_batch``, ``max_delay_scale``, ``delay_beta``)."""
    a = cfg.algorithm
    sd = getattr(cfg, "state_dtype", "float32")
    if a == "asgd":
        return VanillaASGD()
    if a == "delay_asgd":
        return DelayAdaptiveASGD(tau_c=cfg.max_delay_scale * cfg.delay_beta)
    if a == "fedbuff":
        return FedBuff(buffer_size=cfg.buffer_size, state_dtype=sd)
    if a == "ca2fl":
        return CA2FL(buffer_size=cfg.buffer_size, cache_dtype=cfg.cache_dtype,
                     state_dtype=sd)
    if a == "ca2fl_direct":
        return CA2FLDirect(buffer_size=cfg.buffer_size,
                           cache_dtype=cfg.cache_dtype, state_dtype=sd)
    if a == "ace_direct":
        return ACEDirect(cache_dtype=cfg.cache_dtype)
    if a == "ace":
        return ACEIncremental(cache_dtype=cfg.cache_dtype, state_dtype=sd)
    if a == "aced":
        # k_batch > 1 sizes the owner-ring for whole-cohort expiry
        return ACED(tau_algo=cfg.tau_algo, cache_dtype=cfg.cache_dtype,
                    state_dtype=sd,
                    max_cohort=max(1, getattr(cfg, "k_batch", 1)))
    if a == "aced_direct":
        return ACEDDirect(tau_algo=cfg.tau_algo, cache_dtype=cfg.cache_dtype)
    raise ValueError(f"unknown AFL algorithm {a!r}")
