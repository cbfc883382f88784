"""Sampled-staleness engine — port of `repro.core.scan_staleness` (the
paper's Fig. 2/3 protocol) in both of its layouts.

Per tick: sample the arriving client(s) by Gumbel argmax (K = 1) or
Gumbel top-k (K > 1) over speed-skewed log-probabilities with the
availability windows folded in, draw each lane's staleness τ from Exp(β),
read the stale model from a ``(tau_max+1, d)`` ring of recent models,
compute the client payload(s), run the aggregator's `step` /
`step_batch`, and apply the emitted update. When every client is inside its
window the protocol freezes: the tick holds model and aggregator state and
fast-forwards t to the earliest rejoin.

Execution. As in the JAX package, the engine is an init and a tick
(`_staleness_program`). ``init(lr) -> carry`` builds the protocol state: a
dict of tensors with the JAX carry's keys (``w``, ``state``, ``t``,
``n_upd``, ``ring``, ``cursor``, and ``snaps``/``hits`` with eval marks)
plus ``e``, the position in the pre-drawn streams, which takes the place of
JAX's PRNG key. ``tick`` advances the carry by one tick: it reads the
streams at ``e`` on the device and writes every new value back into the
carry's own tensors (the cache rows in place, the rest by copy). A tick
never reads the host and always touches the same addresses, so on the card
`make_staleness_runner` captures one tick as a CUDA graph and replays it
once per event, the counterpart of JAX's one compiled `lax.scan`; on the
CPU, or with ``graph=False``, the same tick runs eagerly.
`make_chunked_staleness_runner` runs it over event slices from a carry that
round-trips through `torch.save`. The eval cadence (`eval_marks_for`,
`snapshot_update`) snapshots the model at each mark the run reaches, and
`run_staleness_scan` evaluates the snapshots on the host after the run.

Randomness. Everything the protocol draws is independent of model values,
so it is made up front: the per-tick gumbel rows, the per-lane ``tau_raw``
(`StalenessRandomness`), the per-(tick, lane) payload noise plus one
noise row per client for the init batch (`PayloadNoise`) and, for a
faulted run, the per-(tick, lane) fault kinds and scales (`FaultSchedule`).
The port draws them from `torch.Generator`s seeded from ``seed``
(`build_staleness_randomness`, `build_payload_noise`,
`build_fault_schedule`, the last on a stream of its own, so a faulted run
and a clean one share their gumbels and τ event for event); a caller may
pass its own (the tests replay the JAX package's streams through
``randomness=``, ``payload_noise=`` and ``faults=``). `jax.random` is never
reproduced.

Guards. With ``guards=True`` the tick runs the JAX package's fault-guard
pipeline on every lane: the payload is multiplied by its fault (NaN,
explode × scale, a sign flip; 1.0 when clean), then a non-finite payload is
quarantined, an over-stale request (injected or natural) rejected, and a
surviving payload with ‖g‖ > ``clip_norm`` scaled to it (``clip_norm ≤ 0``
disables the clip). Counters ride the carry (``carry["guards"]``) and
per-event flags the outputs. ``resync_every`` re-derives a rule's running
sums from its cache (`Aggregator.resync`) on every `resync_every`-th
emitted update: the tick computes the resync every time and selects it
with ``torch.where`` (a captured graph cannot branch on a device value).
Off, neither adds an op to the tick.

Sweeps. `run_staleness_seeds` and `run_staleness_grid` call one runner
once per seed and per (lr, seed) cell: every cell has the same event
count, and lr and ``clip_norm`` are runtime buffers, so one capture serves
the whole sweep.

Checks. ``checkify_invariants`` (default: ``REPRO_CHECKIFY``) puts the JAX
package's sanitize checks in the tick as device-side records
(`repro_torch.core.sanitize`); the runner raises after the run, the chunked
runner after the chunk that violated one. The sweeps build their runners
with the checks off, as JAX's do.

Layouts. ``layout="flat"`` (the default) carries the raveled (d,) model
over a `FlatCache`; ``layout="tree"`` carries the parameter structure
itself (JAX's tree layout): the rules keep tree caches (one stacked cache
per parameter leaf, `repro_torch.core.cache`), the payloads and running
sums are shaped like the parameters, the history ring is a tree cache in
``history_dtype`` (float32, bfloat16 or an int8 ring, tree-only), and the
tick is captured like the flat one. The fused kernels of the flat layout
(`commit_batch`, `row_delta`, `cache_row_update`, `masked_agg`) stay
flat-only, as in JAX; a tree's int8 leaves are quantized and dequantized
by the `quantize_rows` / `dequantize_rows` kernels. The seed and grid
sweeps stay flat, as JAX's are.

The host reference of this engine is
`repro_torch.core.staleness_sim.StalenessSimulator` (flat; a tree run is
held against it through `ravel`). The sharded runner
(`repro_torch.core.scan_sharded`) is this program over a ``("data",
"model")`` mesh (``mesh=``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import leaves, ravel, tree_map, unravel
from repro_torch.core.aggregators import (Aggregator, Arrival, ArrivalBatch,
                                          _gate, wants_cache_init)
from repro_torch.core import sanitize
from repro_torch.core.cache import (DTYPES, MeshBlock, broadcast_lanes,
                                    cache_row_slots, cache_tensors,
                                    init_blocked_cache, init_tree_cache,
                                    tree_cache_reset_, tree_cache_rows,
                                    tree_cache_set_row)
from repro_torch.core.scan_engine import (PayloadNoise, ScanResult, _Program,
                                          _Ticks, _TickRunner, _copy_state_,
                                          _payload_chain, _to_result,
                                          _tree_clone, _tree_copy_,
                                          _use_graph,
                                          _write_outs, build_payload_noise,
                                          default_n_events)
from repro_torch.core.staleness_sim import (FAULT_BYZANTINE, FAULT_EXPLODE,
                                            FAULT_NAN, FAULT_NONE,
                                            FAULT_OVERSTALE, NEVER,
                                            _window_slack, default_tau_max,
                                            staleness_client_probs)
from repro_torch.kernels.backend import resolve_device
from repro_torch.sharding.rules import active_mesh, use_rules
from repro_torch.trace import span


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

    def slice(self, start: int, stop: int) -> "StalenessRandomness":
        """Events ``start..stop-1`` of the stream (the windows whole): the
        slice a chunk of `make_chunked_staleness_runner` consumes."""
        return StalenessRandomness(self.gumbels[start:stop],
                                   self.tau_raw[start:stop], self.leave_at,
                                   self.rejoin_at)


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


# ---------------------------------------------------------------------------
# Client faults: per-event descriptors, runtime tensors like the windows.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSchedule:
    """Per-event fault descriptors of one run (the JAX package's record, as
    tensors), read by the guard pipeline of a runner built with
    ``guards=True``. ``kind`` holds a FAULT_* code (`staleness_sim`),
    ``scale`` the norm multiplier an EXPLODE event applies."""
    kind: torch.Tensor       # (n_events,) int32; (n_events, k_batch) with K > 1
    scale: torch.Tensor      # f32, kind's shape

    @property
    def n_events(self) -> int:
        return int(self.kind.shape[0])

    def counts(self) -> Dict[str, int]:
        """Host-side {kind name: count} of the scheduled faults."""
        k = self.kind.cpu().numpy()
        return {"nan": int((k == FAULT_NAN).sum()),
                "explode": int((k == FAULT_EXPLODE).sum()),
                "byzantine": int((k == FAULT_BYZANTINE).sum()),
                "overstale": int((k == FAULT_OVERSTALE).sum())}

    def slice(self, start: int, stop: int) -> "FaultSchedule":
        """Events ``start..stop-1``: the slice a chunk of
        `make_chunked_staleness_runner` consumes."""
        return FaultSchedule(self.kind[start:stop], self.scale[start:stop])


def no_faults(n_events: int, k_batch: int = 1, device=None) -> FaultSchedule:
    """An all-clean schedule: the guard pipeline runs (clipping, natural
    over-stale rejection) with nothing injected. ``k_batch > 1`` shapes it
    per lane."""
    device = resolve_device(device)
    shape = (n_events,) if k_batch == 1 else (n_events, int(k_batch))
    return FaultSchedule(
        torch.full(shape, FAULT_NONE, dtype=torch.int32, device=device),
        torch.ones(shape, dtype=torch.float32, device=device))


def _fault_seed(seed: int) -> int:
    """The fault stream's generator seed for `seed`: a stream of its own
    (the JAX package folds 201 into the seed's key), so it is neither the
    seed's protocol stream nor another seed's (``seed + 201`` would be the
    protocol stream of seed + 201)."""
    state = np.random.SeedSequence((int(seed), 201)).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def build_fault_schedule(seed: int, n_events: int, *, k_batch: int = 1,
                         nan_rate: float = 0.0, explode_rate: float = 0.0,
                         byzantine_rate: float = 0.0,
                         overstale_rate: float = 0.0,
                         explode_scale: float = 1e4,
                         device=None) -> FaultSchedule:
    """Draw a per-event fault schedule on `device` from a generator of its
    own for `seed` (`_fault_seed`): each event (each lane with ``k_batch >
    1``) independently becomes one fault kind with the given rate — NAN
    poisons the payload, EXPLODE multiplies it by `explode_scale`,
    BYZANTINE flips its sign, OVERSTALE forces the staleness request past
    tau_max. Rates must be ≥ 0 and sum to ≤ 1."""
    rates = (nan_rate, explode_rate, byzantine_rate, overstale_rate)
    if min(rates) < 0 or sum(rates) > 1.0:
        raise ValueError(f"fault rates must be ≥0 and sum to ≤1: {rates}")
    device = resolve_device(device)
    shape = (n_events,) if k_batch == 1 else (n_events, int(k_batch))
    gen = torch.Generator(device=device).manual_seed(_fault_seed(seed))
    u = torch.rand(shape, generator=gen, device=device)
    edges = np.concatenate([[0.0], np.cumsum(rates)])
    kind = torch.full(shape, FAULT_NONE, dtype=torch.int32, device=device)
    for code, lo, hi in zip(
            (FAULT_NAN, FAULT_EXPLODE, FAULT_BYZANTINE, FAULT_OVERSTALE),
            edges[:-1], edges[1:]):
        kind = torch.where((u >= float(lo)) & (u < float(hi)), code, kind)
    return FaultSchedule(kind, torch.full(shape, explode_scale,
                                          dtype=torch.float32, device=device))


def _save_rows(state, idx):
    """``{key: (slots, rows)}``: each cache's storage rows holding client
    rows `idx` (`cache_row_slots`) and their contents, for `_select_state`
    to restore."""
    out = {}
    for k, v in state.items():
        if cache_tensors(v):
            slots = cache_row_slots(v, idx)
            out[k] = (slots, [x.index_select(0, slots)
                              for x in cache_tensors(v)])
    return out


def _select_state(proc, new, old, saved):
    """``where(proc, new, old)`` over the aggregator state. The tensors of
    `old` were never written (the rules replace them), so a select is
    enough; a cache (either layout) in `saved` (`_save_rows`) was written
    in place at its saved storage rows, so a tick that did not process
    restores those rows from it. A cache not in `saved` is taken as it
    stands."""
    out = {}
    for k, v in new.items():
        if cache_tensors(v):
            slots, kept = saved.get(k, (None, ()))
            for t, rows in zip(cache_tensors(v), kept):
                t.index_copy_(0, slots, torch.where(
                    proc, t.index_select(0, slots), rows))
            out[k] = v
        else:
            out[k] = _gate(proc, v, old[k])
    return out


def _tree_global_norm(tree):
    """‖tree‖₂ over all leaves (the tree layout's ``unorm``): the leaves'
    sums of squares added in leaf order, as JAX's."""
    sq = [x.float().square().sum() for x in leaves(tree)]
    return sum(sq[1:], sq[0]).sqrt()


def _tree_lane_norms(tree):
    """(K,) per-lane ‖·‖₂ of a structure whose leaves lead with (K,): lane
    k's `_tree_global_norm`."""
    sq = [x.float().square().reshape(x.shape[0], -1).sum(1)
          for x in leaves(tree)]
    return sum(sq[1:], sq[0]).sqrt()


def _guard_payloads(payloads, kind, scale, clip_norm):
    """The guard pipeline's payload stage over K lanes ((K, d) payloads, or
    a structure whose leaves lead with (K,)): inject each lane's fault
    (× NaN, × `scale` for EXPLODE, × −1 for BYZANTINE; × 1.0, an identity,
    when clean), then clip lanes with ‖g‖ > `clip_norm` to it (``clip_norm
    ≤ 0`` disables; a NaN norm compares False, so a quarantined lane is
    never also clipped); the tree's finite check covers every leaf and its
    norm is the lane's global norm. Returns ``(payloads, finite (K,),
    do_clip (K,))``."""
    mult = torch.where(kind == FAULT_NAN, float("nan"), 1.0)
    mult = mult * torch.where(kind == FAULT_EXPLODE, scale, 1.0)
    mult = torch.where(kind == FAULT_BYZANTINE, -mult, mult)
    if isinstance(payloads, torch.Tensor):
        payloads = payloads * mult[:, None]
        finite = torch.isfinite(payloads).all(1)
        gnorm = torch.linalg.vector_norm(payloads, dim=1)
    else:
        payloads = tree_map(lambda p: p * broadcast_lanes(mult, p), payloads)
        finite = torch.stack([torch.isfinite(x).reshape(x.shape[0], -1)
                              .all(1) for x in leaves(payloads)]).all(0)
        gnorm = _tree_lane_norms(payloads)
    do_clip = (clip_norm > 0) & (gnorm > clip_norm)
    cscale = torch.where(do_clip, clip_norm / torch.clamp(gnorm, min=1e-12),
                         1.0)
    return (tree_map(lambda p: p * broadcast_lanes(cscale, p), payloads),
            finite, do_clip)


def _resync_select(do, synced, state):
    """``where(do, synced, state)`` over the aggregator state: what JAX's
    ``lax.cond(do, agg.resync, identity, state)`` gives, without a branch
    on a device value. A resync only reads the caches and hands the
    tensors it does not recompute back as they were, so only the
    recomputed ones are selected."""
    return {k: v if v is state[k] else _gate(do, v, state[k])
            for k, v in synced.items()}


# ---------------------------------------------------------------------------
# In-scan eval cadence: snapshot buffer written on mark crossings.
# ---------------------------------------------------------------------------

def eval_marks_for(T: int,
                   eval_every: Optional[int]) -> Optional[Tuple[int, ...]]:
    """The server iterations the host simulator evaluates at
    (``t % eval_every == 0 or t == T``), as a sorted tuple."""
    if not eval_every:
        return None
    return tuple(sorted(set(range(eval_every, T + 1, eval_every)) | {T}))


def snapshot_update(snaps, hits, marks, t_new, emit, w):
    """Write `w` into the snapshot row whose mark equals `t_new`, gated on
    `emit` (t lands on a mark only through an emitted update; a freeze's
    fast-forward jump skips its marks, as the host's modulo cadence does);
    a tree model leaf by leaf, into snapshots whose leaves lead with
    (n_marks,). Returns the new ``(snaps, hits)``."""
    hit = emit & (marks == t_new)                        # (n_marks,) bool
    return (tree_map(lambda sn, x: torch.where(broadcast_lanes(hit, sn),
                                               x[None], sn), snaps, w),
            hits | hit)


def _apply_evals(snaps, hits, marks, eval_fn, unravel_fn):
    """Run the host `eval_fn` over the marks the run reached, on the
    parameters `unravel_fn` makes of each snapshot row; with
    ``unravel_fn=None`` the snapshots are a parameter structure whose
    leaves lead with (n_marks,) (the tree layout)."""
    evals, eval_ts = [], []
    reached = hits.cpu().numpy()
    for i, m in enumerate(marks):
        if reached[i]:
            evals.append(eval_fn(
                tree_map(lambda x: x[i], snaps) if unravel_fn is None
                else unravel_fn(snaps[i])))
            eval_ts.append(int(m))
    return evals, eval_ts


# ---------------------------------------------------------------------------
# The program: an init and a tick over a carry of tensors.
# ---------------------------------------------------------------------------

#: the per-event outputs a tick writes at row ``e``
_OUT_DTYPES = {"loss": torch.float32, "emit": torch.bool, "t": torch.int32,
               "unorm": torch.float32, "alive": torch.bool}
#: the guard pipeline's counters (carry) and per-event flags (outputs)
GUARD_KEYS = ("quarantined", "clipped", "rejected")


@dataclasses.dataclass
class _StalenessProgram(_Program):
    """One configuration of the engine (see `_staleness_program`)."""
    marks: Optional[Tuple[int, ...]]
    tau_max: int
    k_batch: int
    local_steps: int
    guards: bool
    resync_every: Optional[int]
    layout: str
    #: the carry's snapshots -> the whole (n_marks, ...) snapshots
    full_snaps: Callable


def _staleness_program(*, grad_fn: Callable, params0, aggregator: Aggregator,
                       n_clients: int, T: int, beta: float,
                       server_lr: Optional[Callable] = None,
                       tau_max: Optional[int] = None,
                       speed_skew: float = 0.0,
                       eval_marks: Optional[Tuple[int, ...]] = None,
                       local_steps: int = 1, local_lr: float = 0.05,
                       init_cache_grads: bool = True, record_w: bool = False,
                       layout: str = "flat", history_dtype: str = "float32",
                       k_batch: int = 1, guards: bool = False,
                       resync_every: Optional[int] = None,
                       checks: bool = False, mesh=None,
                       device=None) -> _StalenessProgram:
    """The engine as the JAX package's `_staleness_program` builds it.

    ``init(lr, init_noise=None, reuse=None) -> carry``: the init batch (one
    payload per client at w⁰ from the noise rows `init_noise`, for the
    cache-init rules), u⁰ applied with `lr`, the ring holding w⁰ (and w¹),
    ``e = 0`` (and the zeroed ``guards`` counters with `guards`); with
    `reuse`, a carry of this program, the ring is that carry's, reset in
    place.

    ``tick(carry, xs, outs)``: one tick, in place. ``xs`` holds the
    pre-drawn streams (``gumbels (E, n)``, ``tau_raw (E,)`` or ``(E, K)``,
    ``noise (E, K, local_steps, ...)``; with `guards` also ``fault_kind``
    and ``fault_scale``, tau_raw's shape), the windows ``leave_at`` /
    ``rejoin_at (n,)``, the 0-d f32 ``lr`` (and with `guards` the 0-d f32
    ``clip_norm``); the tick reads row ``carry["e"]`` of each stream and
    writes row ``e`` of ``outs``. No host value enters it, so it can be
    captured. `server_lr` is None (the tick takes ``xs["lr"]``) or a
    callable of the 0-d int32 iteration tensor.

    `guards` runs the fault-guard pipeline (module docstring; JAX's
    ``guards=True``): a quarantined or rejected arrival consumes its event
    without touching model, cache or running sums (a K = 1 rule still runs
    its step, and the rows it wrote are restored as on a frozen tick), a
    K > 1 lane is judged alone (``valid = lane_alive & ok``). The outputs
    gain the per-event ``quarantined``/``clipped``/``rejected`` flags (bool
    at K = 1, int32 counts of live lanes at K > 1), gated on ``t < T`` and
    not frozen, and the carry their sums. `resync_every` re-derives the
    rule's running sums on every `resync_every`-th emitted update.

    `checks` puts JAX's sanitize checks in the tick where JAX's checkify
    has them (`repro_torch.core.sanitize`): the carry's ``checks`` records
    hold the first event each one failed at, or −1. Off, the tick has no
    check op.

    `layout` picks the model's form, as in JAX: "flat" carries the raveled
    (d,) model, a (tau_max+1, d) ring and (n_marks, d) snapshots; "tree"
    carries `params0`'s structure (dicts and lists of tensors), hands the
    rule the parameter template (tree caches, running sums shaped like the
    parameters) and payloads of that structure, and keeps the ring's rows
    in `history_dtype` ("float32", "bfloat16" or "int8": the ring's int8
    leaves go through the quantize_rows and dequantize_rows kernels on the
    card, or their plain versions for a ``backend="torch"`` rule) and the
    snapshots per leaf. Either ring is a tree cache (`core.cache`), the
    flat one of a single (tau_max+1, d) leaf.

    `mesh` (a ``("data", "model")`` `DeviceMesh`; default: the one of an
    active `use_rules`, else None) lays the flat layout's server state over
    the mesh as `repro.core.scan_sharded` lays JAX's: the rule's caches are
    `BlockedFlatCache` blocks (client rows over ``data``, features over
    ``model``), the ring a block of (tau_max+1, d/model) rows and the
    snapshots (n_marks, d/model); the model, the running sums, the
    payloads and every O(n) tensor stay replicated, and each rank runs the
    same tick on the same streams. The tree layout's state stays whole on
    every rank. With `checks`, each check holds on every rank or on
    none."""
    if layout == "flat":
        if history_dtype != "float32":
            raise ValueError("quantized history ring is tree-layout only")
    elif layout == "tree":
        if record_w:
            raise ValueError("record_w is flat-layout only (a per-event "
                             "model trajectory buffer does not fit the tree "
                             "path's real-model sizes)")
        if history_dtype not in DTYPES:
            raise ValueError(f"history_dtype={history_dtype!r}: one of "
                             f"{sorted(DTYPES)}")
    else:
        raise ValueError(f"unknown layout {layout!r}")
    tree = layout == "tree"
    device = resolve_device(device)
    mesh = mesh if mesh is not None else active_mesh()
    blocked = mesh is not None and not tree
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
    if server_lr is not None and not callable(server_lr):
        raise TypeError("pass a constant lr at call time; server_lr is for "
                        "iteration schedules (callables) only")
    if resync_every is not None and resync_every < 1:
        raise ValueError(f"resync_every={resync_every} must be ≥ 1 or None")
    lr_of_t = ((lambda t, lr: server_lr(t)) if server_lr is not None
               else (lambda t, lr: lr))
    tau_max = tau_max if tau_max is not None else default_tau_max(beta)
    S = tau_max + 1
    wants_init = init_cache_grads and wants_cache_init(agg)
    log_probs = torch.as_tensor(np.log(staleness_client_probs(n, speed_skew)),
                                dtype=torch.float32).to(device)
    marks = (torch.tensor(eval_marks, dtype=torch.int32, device=device)
             if eval_marks is not None else None)

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    payload_fn = _payload_chain(grad_fn, local_steps, local_lr)
    # the two layouts differ only in these (JAX's layout table)
    if tree:
        w0 = tree_map(lambda x: torch.as_tensor(x).to(
            device=device, dtype=torch.float32).clone(), params0)
        d = sum(x.numel() for x in leaves(w0))
        d_tpl = w0              # the rules take the parameter template as d
        unorm = _tree_global_norm
    else:
        w0 = ravel(params0).to(device=device, dtype=torch.float32)
        d = d_tpl = w0.numel()
        unorm = torch.linalg.vector_norm

    # the model history: a tree cache of S rows like w0 (the flat layout's
    # is one (S, d) float32 leaf); its int8 leaves quantize through the
    # rule's `backend`, so a ``backend="torch"`` rule runs no kernel
    backend = getattr(agg, "backend", None)

    # under a mesh (flat layout) the ring is a block of (S, d/model) rows:
    # a read gathers its rows' features, a write stores this rank's slice
    def init_ring(reuse=None):
        # a runner's later calls reset the ring they will be copied into
        # (at a real model's width a second ring would not fit beside it)
        if blocked:
            ring = (init_blocked_cache(S, d, "float32", mesh, device=device,
                                       axes=(None, "cache_d"))
                    if reuse is None else reuse.reset_())
            return ring.set_row(0, w0)
        if reuse is None:
            ring = init_tree_cache(S, w0, history_dtype, device=device,
                                   backend=backend)
        else:
            ring = reuse
            tree_cache_reset_(ring)
        return tree_cache_set_row(ring, 0, w0, backend)

    def rd_rings(ring, cursor, taus):
        # ``history[-(tau+1)]`` for each lane: the model τ emitted updates
        # ago; requires τ ≤ min(t, S−1)
        slots = torch.remainder(cursor - taus, S)
        if blocked:
            return ring.rows(slots)
        return tree_cache_rows(ring, slots, backend)

    def ap_ring(ring, cursor, w, emit):
        # ``history.append(w)`` gated on `emit`: the cursor advances on an
        # emitting tick; on any other it stays and the unchanged model
        # rewrites its own slot (re-quantized, the same codes), so the
        # write is unconditional
        cursor = torch.where(emit, torch.remainder(cursor + 1, S), cursor)
        if blocked:
            return ring.set_row(cursor, w), cursor
        return tree_cache_set_row(ring, cursor, w, backend), cursor

    # the snapshots: (n_marks, d/model) blocks under a mesh (flat layout)
    snap_block = (MeshBlock(mesh, len(eval_marks), d, (None, "cache_d"))
                  if blocked and eval_marks is not None else None)
    snap_part = snap_block.features if snap_block else (lambda w: w)

    def apply_update(w, u, eta, emit):
        # the update in f32, as JAX's: a bf16 update (a bf16 `state_dtype`
        # rule's running mean) times the 0-d f32 η would round to bf16 in
        # PyTorch's promotion; an f32 update's `.float()` is no op
        return tree_map(lambda wl, ul: torch.where(
            emit, wl - eta * ul.float(), wl), w, u)

    def init(lr, init_noise=None, reuse=None):
        # the rule builds its caches under the program's mesh
        if mesh is None or active_mesh() is mesh:
            return _init(lr, init_noise, reuse)
        with use_rules(mesh):
            return _init(lr, init_noise, reuse)

    def _init(lr, init_noise, reuse):
        lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
        if wants_init:
            if init_noise is None:
                raise ValueError(
                    f"{type(agg).__name__} seeds its cache with one payload "
                    "per client: pass the init batch's noise "
                    "(PayloadNoise.init)")
            # one payload per client at w0 (paper Alg. 1 line 1), and u⁰
            # applied before the loop (lines 4-5); the n lanes are views of
            # w0, not n copies
            with span("init.payload"):
                init_rows, _ = payload_fn(
                    tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)),
                             w0),
                    torch.arange(n, dtype=torch.int64, device=device),
                    torch.as_tensor(init_noise).to(device))
            with span("init.rule_state"):
                state = agg.init_state(n, d_tpl, init_rows, device)
                eta0 = lr_of_t(i32(0), lr)
                w = tree_map(lambda wl, r: wl - eta0 * r.mean(0), w0,
                             init_rows)
                del init_rows             # before the ring is allocated
            t0 = 1
        else:
            with span("init.rule_state"):
                state = agg.init_state(n, d_tpl, None, device)
                w, t0 = _tree_clone(w0), 0
        with span("init.ring"):
            ring = init_ring(None if reuse is None else reuse["ring"])
            cursor = i32(0)
            if wants_init:           # history = [w⁰, w¹] after the init update
                ring, cursor = ap_ring(ring, cursor, w,
                                       torch.ones((), dtype=torch.bool,
                                                  device=device))
        carry = {"w": w, "state": state, "t": i32(t0),
                 # emitted-update count: len(history) − 1 of the host deque;
                 # it falls behind t after a freeze's fast-forward jump
                 "n_upd": i32(t0), "ring": ring, "cursor": cursor,
                 "e": torch.zeros((), dtype=torch.int64, device=device)}
        if marks is not None:
            carry["snaps"] = tree_map(lambda x: torch.zeros(
                (marks.shape[0],) + tuple(snap_part(x).shape),
                dtype=torch.float32, device=device), w0)
            carry["hits"] = torch.zeros((marks.shape[0],), dtype=torch.bool,
                                        device=device)
        if guards:
            carry["guards"] = {k: i32(0) for k in GUARD_KEYS}
        if checks:
            # JAX's order of the checks within a tick
            names = ([sanitize.RESYNC] if resync_every else []) + [
                sanitize.MODEL, sanitize.PAYLOAD, sanitize.CURSOR]
            names += sanitize.state_messages(state)
            if K > 1:
                names += (list(sanitize.BATCH_MESSAGES)
                          + sanitize.commit_messages(state))
            carry["checks"] = sanitize.records(names, device)
        return carry

    def tick(carry, xs, outs):
        # the spans (`repro_torch.trace`) cover the tick in order; they
        # record only host ranges, and only while a profiler runs
        e = carry["e"].reshape(1)
        t, n_upd, state = carry["t"], carry["n_upd"], carry["state"]
        with span("tick.sample"):
            # availability: windows folded into the sampling logits; with
            # every client inside its window the tick freezes and t jumps
            # to the thaw
            gone = (xs["leave_at"] <= t) & (t < xs["rejoin_at"])
            logits = torch.where(gone, -torch.inf, log_probs)
            any_alive = (~gone).any()
            thaw_t = torch.clamp(
                torch.where(gone, xs["rejoin_at"], NEVER).amin(), max=T)
            score = logits + xs["gumbels"].index_select(0, e)[0]
            if K == 1:
                js = torch.argmax(score).reshape(1)
            else:
                # Gumbel top-k: the tick's K distinct clients in sampling
                # order
                js = torch.topk(score, K).indices
            tau_req = torch.floor(xs["tau_raw"].index_select(0, e)).int()
            if guards:
                # injected over-stale requests (clamped below for the read)
                f_kind = xs["fault_kind"].index_select(0, e).reshape(-1)
                tau_req = torch.where(f_kind == FAULT_OVERSTALE,
                                      tau_max + 1, tau_req.reshape(-1))
            taus = torch.minimum(tau_req.reshape(-1),
                                 torch.clamp(n_upd, max=tau_max))
        with span("tick.ring_read"):
            stale = rd_rings(carry["ring"], carry["cursor"], taus)
        with span("tick.payload"):
            payloads, losses = payload_fn(
                stale, js, xs["noise"].index_select(0, e)[0])
            del stale
        with span("tick.rule"):
            if guards:
                payloads, finite, do_clip = _guard_payloads(
                    payloads, f_kind,
                    xs["fault_scale"].index_select(0, e).reshape(-1),
                    xs["clip_norm"])
                reject = tau_req > tau_max
                ok = finite & ~reject                          # (K,)
            if K == 1:
                # a frozen K = 1 tick still writes its row in place: keep
                # the old one to restore (at K > 1 an all-invalid batch
                # writes every row back bit-exactly, so nothing needs
                # saving)
                saved = _save_rows(state, js)
                # a quarantined or rejected arrival is undone the same way
                proc = any_alive & ok[0] if guards else any_alive
                new_state, u, emit, lr_scale = agg.step(
                    state, Arrival(js, tree_map(lambda p: p[0], payloads), t,
                                   taus[0]))
                loss = losses[0]
            else:
                saved = {}
                valid = lane_alive = ~gone[js]
                if guards:          # each lane judged alone
                    valid = lane_alive & ok
                proc = valid.any()
                new_state, u, emit, lr_scale = agg.step_batch(
                    state, ArrivalBatch(js, payloads, t, taus, valid))
                loss = (torch.where(valid, losses, 0.0).sum()
                        / torch.clamp(valid.sum(), min=1))
            emit = emit & (t < T) & proc
            # frozen ticks perform no aggregator transition
            new_state = _select_state(proc, new_state, state, saved)
            n_upd_new = n_upd + emit.int()
            found = []                      # the sanitize checks' results
            if resync_every:
                synced = agg.resync(new_state)
                if synced is not new_state:
                    do = emit & (torch.remainder(n_upd_new, resync_every)
                                 == 0)
                    if checks:
                        found += sanitize.check_resync_agreement(
                            new_state, synced, do)
                    new_state = _resync_select(do, synced, new_state)
        with span("tick.apply"):
            eta = lr_of_t(t, xs["lr"]) * lr_scale
            w = apply_update(carry["w"], u, eta, emit)
        with span("tick.ring_write"):
            _, cursor = ap_ring(carry["ring"], carry["cursor"], w, emit)
        with span("tick.outs"):
            if checks:
                # at K > 1 only the lanes the batch applied (a quarantined
                # lane carries its NaN)
                applied = tree_map(
                    lambda p: p[0] if K == 1 else torch.where(
                        broadcast_lanes(valid, p), p, 0.0), payloads)
                found += (sanitize.check_model_finite(w)
                          + sanitize.check_payload_finite(applied, emit)
                          + sanitize.check_cursor_bounds(cursor, S)
                          + sanitize.check_aggregator_state(new_state, n))
                if K > 1:
                    found += (sanitize.check_batch_arrivals(js, taus, valid,
                                                            n, tau_max)
                              + sanitize.check_commit_batch(u, new_state,
                                                            state, valid))
                if mesh is not None:
                    found = sanitize.agree(found, mesh)
                sanitize.record(carry["checks"], found, carry["e"])
            new = {"w": w, "n_upd": n_upd_new, "cursor": cursor,
                   "t": torch.where(any_alive, t + emit.int(), thaw_t)}
            if marks is not None:
                new["snaps"], new["hits"] = snapshot_update(
                    carry["snaps"], carry["hits"], marks, new["t"], emit,
                    snap_part(w))
            row = {"loss": loss, "emit": emit, "t": t, "unorm": unorm(u),
                   "alive": any_alive}
            if record_w:
                row["w"] = w
            if guards:
                # only the live window counts (t < T, not frozen), so
                # chunked totals equal one run's; K > 1 counts live lanes
                win = (t < T) & any_alive
                flags = {"quarantined": ~finite, "rejected": finite & reject,
                         "clipped": ok & do_clip}
                if K == 1:
                    flags = {k: win & v[0] for k, v in flags.items()}
                else:
                    flags = {k: torch.where(win, (lane_alive & v).sum(
                        dtype=torch.int32), 0) for k, v in flags.items()}
                row.update(flags)
            _write_outs(outs, e, row)
        with span("tick.carry"):
            # the new carry goes into the carry's own tensors (every value
            # above is a fresh tensor; the caches were written in place)
            for k, v in new.items():
                _tree_copy_(carry[k], v)
            if guards:
                for k, v in flags.items():
                    carry["guards"][k].add_(v)
            _copy_state_(agg, state, new_state)
            carry["e"].add_(1)

    out_dtypes = dict(_OUT_DTYPES)
    if guards:
        out_dtypes.update(dict.fromkeys(
            GUARD_KEYS, torch.bool if K == 1 else torch.int32))
    return _StalenessProgram(
        init=init, tick=tick, d=d, record_w=record_w, device=device,
        out_dtypes=out_dtypes, checks=checks, marks=eval_marks,
        tau_max=tau_max, k_batch=K, local_steps=local_steps,
        guards=bool(guards), resync_every=resync_every, layout=layout,
        full_snaps=(snap_block.full_features if snap_block else _tree_clone),
        mesh=mesh)


# ---------------------------------------------------------------------------
# Running the tick: the runner, the chunked runner and one run.
# ---------------------------------------------------------------------------

def _staleness_feed(prog: _StalenessProgram, rand: StalenessRandomness,
                    noise_ticks, lr, faults: Optional[FaultSchedule] = None,
                    clip_norm=0.0):
    """An event slice's streams and the run's inputs, checked against the
    program -> ``(streams, inputs)`` for `_Ticks.feed`: the gumbels,
    tau_raw and payload noise (and, for a guarded program, the slice's
    fault schedule, all clean when None), the windows and `lr` (and
    `clip_norm`)."""
    L, K, steps = rand.n_events, prog.k_batch, prog.local_steps
    if tuple(rand.tau_raw.shape) != ((L,) if K == 1 else (L, K)):
        raise ValueError(f"tau_raw of shape {tuple(rand.tau_raw.shape)} "
                         f"for k_batch={K}")
    if tuple(noise_ticks.shape[:3]) != (L, K, steps):
        raise ValueError(f"payload noise ticks of shape "
                         f"{tuple(noise_ticks.shape)} for {L} events, "
                         f"k_batch={K}, local_steps={steps}")
    streams = {"gumbels": rand.gumbels, "tau_raw": rand.tau_raw,
               "noise": noise_ticks}
    dev = prog.device
    inputs = {"leave_at": rand.leave_at, "rejoin_at": rand.rejoin_at,
              "lr": torch.as_tensor(lr, dtype=torch.float32).to(dev)}
    if prog.guards:
        if faults is None:
            faults = no_faults(L, K, dev)
        if tuple(faults.kind.shape) != tuple(rand.tau_raw.shape):
            raise ValueError(
                f"a fault schedule of shape {tuple(faults.kind.shape)} "
                f"for {L} events at k_batch={K}: rebuild it with "
                "build_fault_schedule(..., k_batch=k_batch)")
        streams.update(fault_kind=faults.kind, fault_scale=faults.scale)
        inputs["clip_norm"] = torch.as_tensor(
            clip_norm, dtype=torch.float32).to(dev)
    elif faults is not None or float(clip_norm) > 0:
        raise ValueError("faults or clip_norm given to a runner built "
                         "without guards: build it with guards=True")
    return streams, inputs


class _Runner(_TickRunner):
    """``runner(randomness, payload_noise, lr, faults=None, clip_norm=0.0,
    eager=False) -> (w, state, outs, extras)``; see
    `make_staleness_runner`."""

    def __call__(self, randomness: StalenessRandomness,
                 payload_noise: PayloadNoise, lr=0.0,
                 faults: Optional[FaultSchedule] = None, clip_norm=0.0,
                 eager: bool = False):
        streams, inputs = _staleness_feed(self.prog, randomness,
                                          payload_noise.ticks, lr, faults,
                                          clip_norm)
        ticks = self._run(randomness.n_events, streams, inputs,
                          payload_noise.init, eager)
        carry, extras = ticks.carry, {}
        if self.prog.marks is not None:
            extras = {"snaps": self.prog.full_snaps(carry["snaps"]),
                      "hits": carry["hits"].clone()}
        if self.prog.guards:
            extras["guards"] = _tree_clone(carry["guards"])
        return (_tree_clone(carry["w"]), _tree_clone(carry["state"]),
                {k: v.clone() for k, v in ticks.outs.items()}, extras)


def make_staleness_runner(*, grad_fn: Callable, params0,
                          aggregator: Aggregator, n_clients: int, T: int,
                          beta: float, server_lr: Optional[Callable] = None,
                          tau_max: Optional[int] = None,
                          speed_skew: float = 0.0,
                          eval_marks: Optional[Tuple[int, ...]] = None,
                          local_steps: int = 1, local_lr: float = 0.05,
                          init_cache_grads: bool = True,
                          record_w: bool = False, layout: str = "flat",
                          history_dtype: str = "float32", k_batch: int = 1,
                          guards: bool = False,
                          resync_every: Optional[int] = None,
                          checkify_invariants: Optional[bool] = None,
                          mesh=None, device=None,
                          graph: Optional[bool] = None):
    """Build the runner ``run(randomness, payload_noise, lr, faults=None,
    clip_norm=0.0) -> (w, state, outs, extras)`` once: the counterpart of
    the JAX package's jitted runner. With ``layout="tree"`` the model `w`
    and the snapshots are parameter structures, the rule's caches tree
    caches and the history ring a tree cache in `history_dtype`
    (`_staleness_program`); `grad_fn` then takes and returns the parameter
    structure.

    `lr` is the constant server lr, a number or a 0-d tensor copied into
    the runner's own buffer, so one capture serves every lr (as JAX's traced
    lr does); a callable `server_lr` bakes an iteration schedule in and the
    runtime `lr` is ignored. The event count is ``randomness.n_events``;
    ``payload_noise`` holds the init batch's noise and one row per (tick,
    lane). ``outs`` holds the per-event ``loss``, ``emit``, ``t``,
    ``unorm``, ``alive`` (and ``w`` with `record_w`); with `eval_marks`,
    ``extras`` holds ``snaps (n_marks, d)`` and ``hits (n_marks,)``. All
    results stay on the device.

    ``guards=True`` runs the fault-guard pipeline (`_staleness_program`):
    the call then takes a `FaultSchedule` of the call's event count (None:
    `no_faults`) and a `clip_norm`, both copied into the runner's buffers
    like lr, so one capture serves every schedule and threshold; ``outs``
    gains the ``quarantined``/``clipped``/``rejected`` flags and
    ``extras["guards"]`` their totals. A runner built without guards raises
    when given either. ``resync_every`` re-derives the rule's running sums
    on every `resync_every`-th emitted update.

    ``checkify_invariants`` (default: the ``REPRO_CHECKIFY`` environment
    variable) puts JAX's sanitize checks in the tick (`_staleness_program`):
    the call raises `RuntimeError` with the first violation's message and
    event after the run. Off, the tick has no check op.

    On a CUDA device the runner copies the streams into static buffers;
    its first call runs the first tick eagerly on a side stream (PyTorch's
    warm-up), captures the tick as a CUDA graph and replays it for every
    later event, the host doing nothing else in between (a call with
    another event count captures anew). ``graph=None`` captures on CUDA and runs the same tick eagerly
    on the CPU; ``graph=False`` runs it eagerly on the card too;
    ``graph=True`` on the CPU raises. A capture that fails raises: there is
    no eager fallback. The kernels' launch counters
    (`kernels.ops.launch_counts`) count the replayed launches and the
    first tick's, not the capture's; ``runner.eager_ticks`` counts the
    ticks run eagerly.

    ``runner(..., eager=True)`` runs one call's ticks eagerly on the
    runner's own buffers, on the card too, and keeps its graph for the
    next call: the call to trace where the tick's time goes, since a
    replay runs no host code and so carries none of the tick's spans
    (`repro_torch.trace`). Its results equal a replayed call's bit for
    bit.

    `mesh` runs the program over a ``("data", "model")`` mesh, one process
    a rank, each calling the runner with the same streams
    (`_staleness_program`; `repro_torch.core.scan_sharded`): the call's
    results are replicated, the carry's server state in blocks."""
    prog = _staleness_program(
        grad_fn=grad_fn, params0=params0, aggregator=aggregator,
        n_clients=n_clients, T=T, beta=beta, server_lr=server_lr,
        tau_max=tau_max, speed_skew=speed_skew, eval_marks=eval_marks,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, record_w=record_w, layout=layout,
        history_dtype=history_dtype, k_batch=k_batch, guards=guards,
        resync_every=resync_every,
        checks=sanitize.enabled(checkify_invariants), mesh=mesh,
        device=device)
    return _Runner(prog, _use_graph(graph, prog.device))


@dataclasses.dataclass
class ChunkedStalenessRunner:
    """Chunked execution of the engine: ``init(lr, init_noise) -> carry``,
    then ``chunk(carry, randomness_slice, noise_slice, lr, faults_slice=None,
    clip_norm=0.0) -> (carry, outs)`` over consecutive event slices
    (`StalenessRandomness.slice`, ``PayloadNoise.ticks[a:b]``,
    `FaultSchedule.slice`), bit-identical to one run over the whole stream.
    The carry is a plain dict of tensors (and the caches) holding the full
    protocol state, ``e`` the events consumed so far; it round-trips
    through `torch.save` / `torch.load`, so a run resumes from a checkpoint
    exactly. ``marks`` are the baked eval marks (None without a cadence);
    with marks the carry holds ``snaps``/``hits``, with guards the
    ``guards`` counters."""
    init: Callable
    chunk: Callable
    marks: Optional[Tuple[int, ...]]
    tau_max: int
    #: arrivals per tick; the slices carry the matching tau_raw lane axis
    k_batch: int = 1
    #: the guard pipeline is in the tick (chunk takes the fault slices and
    #: clip_norm; the carry holds the counters)
    guards: bool = False
    resync_every: Optional[int] = None
    #: the sanitize checks are in the tick (the carry holds their records;
    #: chunk raises at the slice that violated one)
    checkify_invariants: bool = False
    #: "flat" or "tree" (the carry's model, ring and caches)
    layout: str = "flat"
    #: the ("data", "model") mesh the program runs over (None: one device)
    mesh: object = None


def make_chunked_staleness_runner(*, capacity: int,
                                  graph: Optional[bool] = None,
                                  **kwargs) -> ChunkedStalenessRunner:
    """`make_staleness_runner`'s program (same keyword arguments) as an
    init and a chunk over slices of at most `capacity` events; a longer
    slice raises. ``chunk`` copies the carry into the tick's static
    buffers, replays the captured tick once per event of the slice (or
    runs it eagerly, as `graph` says) and returns a copy of the carry.
    With ``checkify_invariants`` (default: ``REPRO_CHECKIFY``) a chunk
    whose slice violated a sanitize check raises `RuntimeError` with the
    check's message and the event (counted from the run's start). A
    ``mesh=`` keyword runs it over that mesh, as `make_staleness_runner`
    does."""
    checks = sanitize.enabled(kwargs.pop("checkify_invariants", None))
    prog = _staleness_program(checks=checks, **kwargs)
    ticks = _Ticks(prog, capacity, _use_graph(graph, prog.device))

    def chunk(carry, randomness: StalenessRandomness, noise_ticks, lr=0.0,
              faults: Optional[FaultSchedule] = None, clip_norm=0.0):
        L = ticks.feed(*_staleness_feed(prog, randomness, noise_ticks, lr,
                                        faults, clip_norm))
        ticks.load(carry)
        ticks.carry["e"].zero_()          # the slice is read from its row 0
        ticks.run(L)
        if checks:
            # the records hold events of the slice
            sanitize.raise_first(ticks.carry["checks"], int(carry["e"]))
        out = _tree_clone(ticks.carry)
        out["e"] = carry["e"].to(out["e"].device) + L
        return out, {k: v[:L].clone() for k, v in ticks.outs.items()}

    return ChunkedStalenessRunner(prog.init, chunk, prog.marks, prog.tau_max,
                                  prog.k_batch, prog.guards,
                                  prog.resync_every, checks, prog.layout,
                                  prog.mesh)


def _check_faults(faults: FaultSchedule, n_events: Optional[int],
                  k_batch: int) -> None:
    """The JAX package's rules for a schedule: its event count is the
    run's, and it was built for the run's `k_batch`."""
    if n_events is not None and n_events != faults.n_events:
        raise ValueError(
            f"n_events={n_events} != faults.n_events={faults.n_events}")
    lanes = faults.kind.shape[1] if faults.kind.dim() == 2 else 1
    if lanes != k_batch:
        raise ValueError(
            f"faults built for k_batch={lanes} but the engine runs "
            f"k_batch={k_batch}: rebuild the schedule with "
            "build_fault_schedule(..., k_batch=k_batch)")


def _make_runner(mesh, **kwargs):
    """The runner for `mesh`: `make_staleness_runner` without one, the
    sharded runner with one (`repro_torch.core.scan_sharded`)."""
    if mesh is None:
        return make_staleness_runner(**kwargs)
    from repro_torch.core.scan_sharded import make_sharded_staleness_runner
    return make_sharded_staleness_runner(mesh=mesh, **kwargs)


def _staleness_result(run, T: int, n_init: int, marks, eval_fn,
                      params0) -> ScanResult:
    """The host record of one runner call ``(w, state, outs, extras)``,
    the eval cadence's `eval_fn` applied to its snapshots. A tree run's
    model is raveled (`ScanResult.w` is (d,), as JAX's)."""
    w, _, outs, extras = run
    flat = isinstance(w, torch.Tensor)
    evals, eval_ts = [], []
    if marks is not None and eval_fn is not None:
        evals, eval_ts = _apply_evals(
            extras["snaps"], extras["hits"], marks, eval_fn,
            (lambda f: unravel(f, params0)) if flat else None)
    host = {k: v.cpu().numpy() for k, v in outs.items()}
    return _to_result((w if flat else ravel(w)).cpu().numpy(), host, T,
                      n_init, evals=evals, eval_ts=eval_ts)


def run_staleness_scan(*, grad_fn: Callable, params0, aggregator: Aggregator,
                       n_clients: int, server_lr, T: int, beta: float = 5.0,
                       tau_max: Optional[int] = None, speed_skew: float = 0.0,
                       dropout_frac: float = 0.0,
                       dropout_at: Optional[int] = None,
                       rejoin_at: Optional[int] = None, windows=None,
                       eval_fn: Optional[Callable] = None,
                       eval_every: Optional[int] = None,
                       n_events: Optional[int] = None, local_steps: int = 1,
                       local_lr: float = 0.05, init_cache_grads: bool = True,
                       seed: int = 0, record_w: bool = False,
                       layout: str = "flat", history_dtype: str = "float32",
                       faults: Optional[FaultSchedule] = None,
                       clip_norm: float = 0.0,
                       resync_every: Optional[int] = None,
                       k_batch: int = 1,
                       checkify_invariants: Optional[bool] = None,
                       mesh=None, device=None,
                       randomness: Optional[StalenessRandomness] = None,
                       payload_noise: Optional[PayloadNoise] = None
                       ) -> ScanResult:
    """One run of the sampled-staleness protocol, through
    `make_staleness_runner` (a captured CUDA graph on the card).

    `grad_fn(w (B, d), clients (B,), noise (B, ...)) -> (loss (B,),
    grads (B, d))` computes B client gradients at B models; it also offers
    ``sample_noise(lead_shape, generator, device)`` for the noise it
    consumes (see `repro_torch.core.fl_tasks.ClientGrad`). `params0` is the
    initial model, a flat tensor or a parameter structure raveled in the
    JAX package's order (`repro_torch.convert.ravel`). `server_lr` is a
    float or a callable of the 0-d int32 iteration tensor. With `eval_fn`
    (parameters -> metrics), the model is snapshotted at the marks
    ``eval_marks_for(T, eval_every or T)`` and `eval_fn` runs on the host
    after the run on those the run reached (`ScanResult.evals`/`eval_ts`).

    ``layout="tree"`` carries the model as `params0`'s structure: `grad_fn`
    takes a structure whose leaves lead with (B,) and returns ``(loss (B,),
    grads)`` of that structure, the rule keeps tree caches, the history
    ring is a tree cache in `history_dtype` ("int8" quantizes each ring
    row per leaf, leaving the exact replay contract by design, as JAX's),
    and `ScanResult.w` is the raveled final model.

    ``faults`` (a `FaultSchedule`) or ``clip_norm > 0`` turn the guard
    pipeline on, as in the JAX package (`ScanResult.faults` holds its
    counters); the schedule's event count is the run's (an `n_events` that
    differs raises, as does a schedule built for another `k_batch`).
    ``resync_every`` re-derives the rule's running sums from its cache on
    every `resync_every`-th emitted update. ``checkify_invariants``
    (default: ``REPRO_CHECKIFY``) raises on a violated sanitize check.

    The run is on the GPU unless ``device="cpu"``; with no GPU and no CPU
    request it raises. ``randomness`` / ``payload_noise`` replace the
    streams drawn from `seed` (the event count is then theirs).
    ``k_batch > 1`` consumes K arrivals per tick through `step_batch` (the
    direct rules have none and raise `NotImplementedError`, as in the JAX
    package). With `mesh` (a ``("data", "model")`` `DeviceMesh`; every
    rank calls with the same arguments) the run is the sharded runner's
    (`repro_torch.core.scan_sharded`)."""
    device = resolve_device(device)
    n, K, agg = n_clients, int(k_batch), aggregator
    guards = faults is not None or clip_norm > 0
    if faults is not None:
        _check_faults(faults, n_events, K)
        n_events = faults.n_events
    marks = (eval_marks_for(T, eval_every or T) if eval_fn is not None
             else None)
    runner = _make_runner(
        mesh, grad_fn=grad_fn, params0=params0, aggregator=agg, n_clients=n,
        T=T, beta=beta, server_lr=server_lr if callable(server_lr) else None,
        tau_max=tau_max, speed_skew=speed_skew, eval_marks=marks,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, record_w=record_w, layout=layout,
        history_dtype=history_dtype, k_batch=K, guards=guards,
        resync_every=resync_every, checkify_invariants=checkify_invariants,
        device=device)
    if randomness is not None:
        n_events = randomness.n_events
    elif n_events is None:
        n_events = (default_n_events(agg, T, init_cache_grads)
                    + _window_slack(n, rejoin_at, windows))
    if randomness is None:
        randomness = build_staleness_randomness(
            seed, n_events, n, beta, dropout_frac, speed_skew,
            dropout_at=dropout_at, rejoin_at=rejoin_at, windows=windows,
            k_batch=K, device=device)
    if payload_noise is None:
        payload_noise = build_payload_noise(grad_fn, seed, n_events, n, K,
                                            local_steps, device)
    run = runner(randomness, payload_noise,
                 0.0 if callable(server_lr) else server_lr, faults, clip_norm)
    wants_init = init_cache_grads and wants_cache_init(agg)
    return _staleness_result(run, T, n if wants_init else 0, marks, eval_fn,
                             params0)


def _staleness_sweep(*, grad_fn: Callable, params0, aggregator: Aggregator,
                     n_clients: int, T: int, seeds: Sequence[int],
                     lrs: Sequence, server_lr: Optional[Callable], beta,
                     tau_max, speed_skew, dropout_frac, dropout_at,
                     rejoin_at, windows, eval_fn, eval_every, n_events,
                     local_steps, local_lr, init_cache_grads, runner,
                     fault_rates, clip_norm, resync_every, k_batch, device,
                     randomness, payload_noise, faults,
                     mesh) -> List[List[ScanResult]]:
    """``results[i_lr][i_seed]`` of one runner called once per (lr, seed)
    cell, seed-outer: each seed's streams (and fault schedule) are drawn
    once and serve every lr, as JAX's nested vmap broadcasts them. Every
    cell has the same event count, so the runner captures once. A runner
    built here has the sanitize checks off, as JAX's sweeps have."""
    device = resolve_device(device)
    n, K, agg = n_clients, int(k_batch), aggregator
    guards = bool(fault_rates) or clip_norm > 0 or faults is not None
    for name, given in (("randomness", randomness),
                        ("payload_noise", payload_noise), ("faults", faults)):
        if given is not None and len(given) != len(seeds):
            raise ValueError(f"{len(given)} {name} entries for "
                             f"{len(seeds)} seeds")
    if randomness is not None:
        n_events = randomness[0].n_events
    elif faults is not None:
        n_events = faults[0].n_events
    elif n_events is None:
        n_events = (default_n_events(agg, T, init_cache_grads)
                    + _window_slack(n, rejoin_at, windows))
    marks = (eval_marks_for(T, eval_every or T) if eval_fn is not None
             else None)
    if runner is None:
        runner = _make_runner(
            mesh, grad_fn=grad_fn, params0=params0, aggregator=agg,
            n_clients=n, T=T, beta=beta, server_lr=server_lr, tau_max=tau_max,
            speed_skew=speed_skew, eval_marks=marks, local_steps=local_steps,
            local_lr=local_lr, init_cache_grads=init_cache_grads, k_batch=K,
            guards=guards, resync_every=resync_every,
            checkify_invariants=False, device=device)
    else:
        prog = runner.prog
        have = (prog.guards, prog.resync_every, prog.marks, prog.k_batch)
        want = (guards, resync_every, marks, K)
        if have != want:
            raise ValueError(
                f"a runner built with (guards, resync_every, eval_marks, "
                f"k_batch) = {have} for a sweep that needs {want}")
    wants_init = init_cache_grads and wants_cache_init(agg)
    results = [[None] * len(seeds) for _ in lrs]
    for i, seed in enumerate(seeds):
        rand = (randomness[i] if randomness is not None else
                build_staleness_randomness(
                    seed, n_events, n, beta, dropout_frac, speed_skew,
                    dropout_at=dropout_at, rejoin_at=rejoin_at,
                    windows=windows, k_batch=K, device=device))
        noise = (payload_noise[i] if payload_noise is not None else
                 build_payload_noise(grad_fn, seed, n_events, n, K,
                                     local_steps, device))
        if rand.n_events != n_events:
            raise ValueError(f"seed {seed}: {rand.n_events} events, the "
                             f"sweep's cells have {n_events}")
        fa = None
        if guards:
            fa = (faults[i] if faults is not None else build_fault_schedule(
                seed, n_events, k_batch=K, device=device,
                **(fault_rates or {})))
            _check_faults(fa, n_events, K)
        for j, lr in enumerate(lrs):
            results[j][i] = _staleness_result(
                runner(rand, noise, lr, fa, clip_norm), T,
                n if wants_init else 0, marks, eval_fn, params0)
    return results


def run_staleness_seeds(*, grad_fn: Callable, params0,
                        aggregator: Aggregator, n_clients: int, server_lr,
                        T: int, seeds: Sequence[int], beta: float = 5.0,
                        tau_max: Optional[int] = None,
                        speed_skew: float = 0.0, dropout_frac: float = 0.0,
                        dropout_at: Optional[int] = None,
                        rejoin_at: Optional[int] = None, windows=None,
                        eval_fn: Optional[Callable] = None,
                        eval_every: Optional[int] = None,
                        n_events: Optional[int] = None, local_steps: int = 1,
                        local_lr: float = 0.05, init_cache_grads: bool = True,
                        runner=None,
                        fault_rates: Optional[Dict[str, float]] = None,
                        clip_norm: float = 0.0,
                        resync_every: Optional[int] = None,
                        k_batch: int = 1, device=None,
                        randomness: Optional[Sequence[StalenessRandomness]]
                        = None,
                        payload_noise: Optional[Sequence[PayloadNoise]] = None,
                        faults: Optional[Sequence[FaultSchedule]] = None,
                        mesh=None) -> List[ScanResult]:
    """One `ScanResult` per seed, each seed's run equal bit for bit to
    `run_staleness_scan` with that seed: one runner called once per seed,
    so one capture serves the sweep. Pass `runner` (a
    `make_staleness_runner` result whose ``guards``, ``resync_every``,
    ``eval_marks`` and ``k_batch`` match the sweep's, else it raises) to
    reuse it across calls. ``fault_rates`` (`build_fault_schedule`'s
    rates; each seed draws its own schedule) or ``clip_norm > 0`` turn the
    guards on; ``resync_every`` the periodic recompute. ``randomness``,
    ``payload_noise`` and ``faults`` take per-seed lists in place of the
    streams drawn from each seed (the tests replay the JAX package's)."""
    lr = 0.0 if callable(server_lr) else float(server_lr)
    return _staleness_sweep(
        grad_fn=grad_fn, params0=params0, aggregator=aggregator,
        n_clients=n_clients, T=T, seeds=seeds, lrs=[lr],
        server_lr=server_lr if callable(server_lr) else None, beta=beta,
        tau_max=tau_max, speed_skew=speed_skew, dropout_frac=dropout_frac,
        dropout_at=dropout_at, rejoin_at=rejoin_at, windows=windows,
        eval_fn=eval_fn, eval_every=eval_every, n_events=n_events,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, runner=runner,
        fault_rates=fault_rates, clip_norm=clip_norm,
        resync_every=resync_every, k_batch=k_batch, device=device,
        randomness=randomness, payload_noise=payload_noise, faults=faults,
        mesh=mesh)[0]


def run_staleness_grid(*, grad_fn: Callable, params0, aggregator: Aggregator,
                       n_clients: int, lrs: Sequence[float], T: int,
                       seeds: Sequence[int], beta: float = 5.0,
                       tau_max: Optional[int] = None, speed_skew: float = 0.0,
                       dropout_frac: float = 0.0,
                       dropout_at: Optional[int] = None,
                       rejoin_at: Optional[int] = None, windows=None,
                       eval_fn: Optional[Callable] = None,
                       eval_every: Optional[int] = None,
                       n_events: Optional[int] = None, local_steps: int = 1,
                       local_lr: float = 0.05, init_cache_grads: bool = True,
                       runner=None,
                       fault_rates: Optional[Dict[str, float]] = None,
                       clip_norm: float = 0.0,
                       resync_every: Optional[int] = None,
                       k_batch: int = 1, device=None,
                       randomness: Optional[Sequence[StalenessRandomness]]
                       = None,
                       payload_noise: Optional[Sequence[PayloadNoise]] = None,
                       faults: Optional[Sequence[FaultSchedule]] = None,
                       mesh=None) -> List[List[ScanResult]]:
    """The lr-tuning grid × seed sweep: ``results[i_lr][i_seed]``, each
    cell equal bit for bit to `run_staleness_scan` with that seed and lr.
    Each seed's streams (and schedule) are drawn once and serve every lr;
    lr is the runner's runtime buffer, so one capture serves the whole
    grid (``runner.captures == 1`` on the card). The other arguments are
    `run_staleness_seeds`'s."""
    return _staleness_sweep(
        grad_fn=grad_fn, params0=params0, aggregator=aggregator,
        n_clients=n_clients, T=T, seeds=seeds,
        lrs=[float(lr) for lr in lrs], server_lr=None, beta=beta,
        tau_max=tau_max, speed_skew=speed_skew, dropout_frac=dropout_frac,
        dropout_at=dropout_at, rejoin_at=rejoin_at, windows=windows,
        eval_fn=eval_fn, eval_every=eval_every, n_events=n_events,
        local_steps=local_steps, local_lr=local_lr,
        init_cache_grads=init_cache_grads, runner=runner,
        fault_rates=fault_rates, clip_norm=clip_norm,
        resync_every=resync_every, k_batch=k_batch, device=device,
        randomness=randomness, payload_noise=payload_noise, faults=faults,
        mesh=mesh)
