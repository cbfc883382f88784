"""Server aggregation rules of the flat engine — port of the ACE, ACED and
CA²FL rules of `repro.core.aggregators`:

  * CA²FL          [Wang et al., 2024]  buffer M + cached calibration, lazy
                                        O(d) calibration sum
  * ACE incremental (paper Alg. a.5)    u ← u + (g − dq(C_j))/n, O(d)
  * ACED            (paper Alg. a.1)    bounded-delay active set τ_algo,
                                        incremental O(d) sum + expiry
                                        owner-ring

Every rule is a transition

    step(state, arr) -> (state', update (d,), emit (bool 0-d), lr_scale)

with `torch.where`-gated emission: no Python branching on tensor values and
no host read, so a tick of the engine never waits for the card. `step_batch`
is the K-arrival form. States are dicts of tensors plus one `FlatCache`.
The cache is updated **in place** (see `repro_torch.core.cache`); every
other state entry is replaced by a new tensor, never written in place, so
an engine can keep the previous state and select between the two. The
server applies ``w ← w − η · lr_scale · update``.

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

import torch

from repro_torch.core.cache import (cache_mean, cache_n,
                                    cache_row, cache_rows, cache_set_row,
                                    cache_set_row_delta, cache_set_rows_delta,
                                    cache_sum, flat_commit_batch,
                                    init_flat_cache, row_index)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref


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


def _masked_batch_sum(rows, mask):
    """``Σ_{k : mask[k]} rows[k]`` in f32, `where`-gated: a quarantined
    lane's payload may be NaN/inf, and ``NaN · 0`` would poison the sum."""
    return torch.where(mask[:, None], rows.float(), 0.0).sum(0)


def _inv_count(count):
    """``1 / max(count, 1)`` in f32 (IEEE reciprocal)."""
    return torch.clamp(count, min=1).float().reciprocal()


class Aggregator:
    """Base: subclasses define init_state / step / step_batch."""
    name = "base"

    def init_state(self, n: int, d: int, init_grads=None, device=None):
        """Initial server state for n clients of dimension d; `init_grads`
        is an (n, d) tensor for the cache-init rules."""
        raise NotImplementedError

    def step(self, state, arr: Arrival):
        """-> (state, update (d,), emit (0-d bool), lr_scale)."""
        raise NotImplementedError

    def step_batch(self, state, batch: ArrivalBatch):
        """K-arrival transition: one aggregation and one emission decision
        for the whole batch; invalid lanes are perfect no-ops, and a batch
        with no valid lane leaves the cache unchanged."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support K-batched arrivals")

    def resync(self, state):
        """Exact self-heal: re-derive every incrementally maintained running
        aggregate from the per-client cache. O(n·d); rules without running
        sums return the state unchanged."""
        return state


# ---------------------------------------------------------------------------

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
    fused_commit: Optional[bool] = None
    backend: Optional[str] = None
    name = "ca2fl"

    def init_state(self, n, d, init_grads=None, device=None):
        h = init_flat_cache(n, d, self.cache_dtype, init_grads, device)
        mean = cache_mean(h)
        dev = h.data.device
        return {"h": h, "h_bar": mean, "h_sum": mean * n,
                "accum": torch.zeros((d,), dtype=torch.float32, device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def _emit(self, count):
        emit = count >= self.buffer_size
        inv = torch.where(emit, _inv_count(count), 0.0)
        return emit, inv

    def step(self, state, arr):
        j = row_index(arr.client, state["h"].data.device)
        h, delta, old = cache_set_row_delta(state["h"], j, arr.payload,
                                            backend=self.backend)
        accum = state["accum"] + (arr.payload.float() - old)
        h_sum = state["h_sum"] + delta
        count = state["count"] + 1
        emit, inv = self._emit(count)
        update = state["h_bar"] * emit.float() + accum * inv
        h_bar = torch.where(emit, h_sum * (1.0 / cache_n(h)), state["h_bar"])
        new_state = {"h": h, "h_bar": h_bar, "h_sum": h_sum,
                     "accum": torch.where(emit, 0.0, accum),
                     "count": torch.where(emit, 0, count)}
        return new_state, update, emit, 1.0

    def step_batch(self, state, batch):
        h = state["h"]
        js = row_index(batch.clients, h.data.device)
        valid = batch.valid
        count = state["count"] + valid.sum(dtype=torch.int32)
        emit, inv = self._emit(count)
        inv_n = 1.0 / cache_n(h)
        if kernel_ops.fused_commit_enabled(self.fused_commit):
            # fused commit, basis [accum, h_sum, h_bar, S_Δ, S_A, S_B, S_G]
            # with lane_a = lane_g = valid (S_G − S_A = Σ_valid(g − old)):
            #   accum' = (1−g)·(accum + S_G − S_A)
            #   h_sum' = h_sum + S_Δ
            #   h_bar' = g·inv_n·h_sum' + (1−g)·h_bar
            #   update = g·h_bar + inv·(accum + S_G − S_A)
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
                h, js, batch.payloads, valid,
                torch.stack((state["accum"], state["h_sum"], state["h_bar"])),
                coef, upd_w, lane_a=vf, lane_g=vf, backend=self.backend)
            new_state = {"h": h, "h_bar": out[2], "h_sum": out[1],
                         "accum": out[0],
                         "count": torch.where(emit, 0, count)}
            return new_state, update, emit, 1.0
        h, delta, old = cache_set_rows_delta(h, js, batch.payloads, valid)
        accum = state["accum"] + _masked_batch_sum(
            batch.payloads.float() - old, valid)
        h_sum = state["h_sum"] + delta.sum(0)
        update = state["h_bar"] * emit.float() + accum * inv
        h_bar = torch.where(emit, h_sum * inv_n, state["h_bar"])
        new_state = {"h": h, "h_bar": h_bar, "h_sum": h_sum,
                     "accum": torch.where(emit, 0.0, accum),
                     "count": torch.where(emit, 0, count)}
        return new_state, update, emit, 1.0

    def resync(self, state):
        return {**state, "h_sum": cache_sum(state["h"])}


@dataclasses.dataclass
class ACEIncremental(Aggregator):
    """Paper Algorithm a.5: u ← u + (g − dq(C_j))/n — O(d) per arrival.

    Exact under an int8 cache: the subtracted value is the dequantized row
    that was previously added, so ``u == mean_i dq(C_i)`` is invariant. The
    K = 1 int8 step goes through the fused `cache_row_update` kernel; the
    K-arrival step through the fused commit kernel."""
    cache_dtype: str = "float32"
    fused_commit: Optional[bool] = None
    backend: Optional[str] = None
    name = "ace"
    cache_init = True

    def init_state(self, n, d, init_grads=None, device=None):
        cache = init_flat_cache(n, d, self.cache_dtype, init_grads, device)
        return {"cache": cache, "u": cache_mean(cache)}

    def step(self, state, arr):
        cache, u = state["cache"], state["u"]
        dev = cache.data.device
        j = row_index(arr.client, dev)
        true = torch.ones((), dtype=torch.bool, device=dev)
        if cache.quantized:
            c_row = cache.data.index_select(0, j)[0]
            old_scale = cache.scale.index_select(0, j)[0]
            new_scale = kernel_ref.row_scale(arr.payload)
            inv_n = torch.full((), 1.0 / cache.n, dtype=torch.float32,
                               device=dev)
            u, q_row = kernel_ops.cache_row_update(
                u, arr.payload, c_row, old_scale, new_scale, inv_n,
                backend=self.backend)
            cache.data.index_copy_(0, j, q_row[None])
            cache.scale.index_copy_(0, j, new_scale.reshape(1))
            return {"cache": cache, "u": u}, u, true, 1.0
        n = cache_n(cache)
        old = cache_row(cache, j)
        cache = cache_set_row(cache, j, arr.payload)
        new = cache_row(cache, j)
        u = u + (new - old) / n
        return {"cache": cache, "u": u}, u, true, 1.0

    def step_batch(self, state, batch):
        # Batched Alg. a.5: u += Σ_k (dq(new_k) − dq(old_k))/n in one O(K·d)
        # pass — the fused commit kernel (basis [u, S_Δ, ...]:
        # u' = u + S_Δ/n), or the op chain.
        cache = state["cache"]
        dev = cache.data.device
        js = row_index(batch.clients, dev)
        n = cache_n(cache)
        emit = batch.valid.any()
        if kernel_ops.fused_commit_enabled(self.fused_commit):
            coef = torch.zeros((1, 5), dtype=torch.float32, device=dev)
            coef[0, 0] = 1.0
            coef[0, 1] = 1.0 / n
            cache, _, u = flat_commit_batch(
                cache, js, batch.payloads, batch.valid, state["u"][None],
                coef, coef[0], backend=self.backend)
            return {"cache": cache, "u": u}, u, emit, 1.0
        cache, delta, _ = cache_set_rows_delta(cache, js, batch.payloads,
                                               batch.valid)
        u = state["u"] + delta.sum(0) / n
        return {"cache": cache, "u": u}, u, emit, 1.0

    def resync(self, state):
        return {**state, "u": cache_mean(state["cache"])}


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
    so the masked sweep retires exactly the owners the loop would."""
    tau_algo: int = 10
    cache_dtype: str = "float32"
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
        cache = init_flat_cache(n, d, self.cache_dtype, init_grads, device)
        dev = cache.data.device
        ring_shape = ((self.ring_size,) if self.max_cohort == 1
                      else (self.ring_size, self.max_cohort))
        asum = cache_sum(cache)
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

    def _sweep(self, state, t, first_slot):
        """Expiry sweep over ring slots ``first_slot..P-1``: slot i holds
        the owners with t_start ≡ t−τ−1−i (mod P); it is visited when
        i < Δt and retires each owner whose t_start ≤ t−τ−1. Returns
        ``(dead_sum (d,), n_dead, ring')`` — the O(d) sum of the retired
        dequantized rows, read from the pre-arrival cache."""
        cache, ring = state["cache"], state["ring"]
        P, tau = self.ring_size, self.tau_algo
        dev = ring.device
        dt = torch.clamp(t - state["t_prev"], 0, P)
        i = torch.arange(first_slot, P, dtype=torch.int32, device=dev)
        s = torch.remainder(t - tau - 1 - i, P).long()
        owners = ring.index_select(0, s)
        ow = torch.clamp(owners, min=0).long()
        visit = (i < dt).reshape((-1,) + (1,) * (owners.dim() - 1))
        gone = visit & (owners >= 0) & (state["t_start"][ow] <= t - tau - 1)
        rows = cache_rows(cache, ow.reshape(-1))
        dead = (rows * gone.reshape(-1, 1).float()).sum(0)
        ring = ring.index_copy(0, s, torch.where(gone, -1, owners))
        return dead, gone.sum(dtype=torch.int32), ring

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
        dev = cache.data.device
        if self.max_cohort > 1:
            # the (P, max_cohort) ring speaks cohorts — route single
            # arrivals through the batched transition as a 1-lane batch
            return self.step_batch(state, ArrivalBatch(
                clients=row_index(arr.client, dev), payloads=arr.payload[None],
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
        k0c = torch.clamp(k0, min=0).long()
        dead = (dt >= 1) & (k0 >= 0) & (t_start[k0c] <= t - tau - 1)
        dead_row = cache_row(cache, k0c)
        ring = ring.index_copy(0, s0, torch.where(dead, -1, k0))
        jump_sum, n_jump, ring = self._sweep({**state, "ring": ring}, t, 1)
        asum = state["asum"] - jump_sum
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
        asum = asum - g_dead * dead_row - g_fire * init_sum + delta + g_ret * old
        count = count + 1 - was_active[0].int()
        init_sum = (1.0 - g_fire) * init_sum - was_init.float() * old
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

        update = asum * _inv_count(count)
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
        dev = cache.data.device
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
        dead_sum, n_dead, ring = self._sweep(state, t, 0)
        asum = state["asum"] - dead_sum
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
        if kernel_ops.fused_commit_enabled(self.fused_commit):
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
            cache, delta, old = cache_set_rows_delta(cache, js,
                                                     batch.payloads, valid)
            asum = (asum - g_fire * init_sum + delta.sum(0)
                    + _masked_batch_sum(old, ret))
            init_sum = ((1.0 - g_fire) * init_sum
                        - _masked_batch_sum(old, was_init))
            update = asum * inv
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
        return {**state, "asum": cache_sum(cache, active),
                "count": active.sum(dtype=torch.int32),
                "init_sum": cache_sum(cache, init_mask),
                "init_count": init_mask.sum(dtype=torch.int32)}


def make_aggregator(cfg) -> Aggregator:
    """Build from a config with the fields of `repro.configs.AFLConfig`
    (``algorithm``, ``cache_dtype``, ``buffer_size``, ``tau_algo``,
    ``k_batch``); the port has the ace, aced and ca2fl rules."""
    a = cfg.algorithm
    if a == "ca2fl":
        return CA2FL(buffer_size=cfg.buffer_size, cache_dtype=cfg.cache_dtype)
    if a == "ace":
        return ACEIncremental(cache_dtype=cfg.cache_dtype)
    if a == "aced":
        # k_batch > 1 sizes the owner-ring for whole-cohort expiry
        return ACED(tau_algo=cfg.tau_algo, cache_dtype=cfg.cache_dtype,
                    max_cohort=max(1, getattr(cfg, "k_batch", 1)))
    raise ValueError(f"unknown or not yet ported AFL algorithm {a!r}")
