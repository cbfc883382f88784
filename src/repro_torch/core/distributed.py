"""The AFL server step over a model's parameter structure — the port of
`repro.core.distributed` (one device; the JAX package's pjit layout waits
for the sharded runner, ROADMAP A10).

One step is one server iteration of Algorithm 1 / a.1:
  1. the arriving client's gradient of ``loss_fn`` at the current
     parameters (`torch.autograd.grad` over the parameter leaves);
  2. the server rule updates its per-client cache and running mean (ACE
     incremental O(d); ACED's active set; the baselines likewise) through
     the layout-generic `Aggregator.step` of `repro_torch.core.aggregators`
     — the rule bodies the engines and host references run — on tree
     caches shaped like the parameters (an int8 cache writes and reads each
     leaf through the `quantize_rows` / `dequantize_rows` kernels);
  3. ``w ← w + opt.update(scale · u)``.

Staleness is emergent: a client's cache row was written when it last
arrived, so its age in server iterations is the paper's τ_i^t; the caller
passes the arrival's staleness for the rules that read it. A rule writes its
cache in place, so the state a step was given is spent. The metrics are
0-d tensors on the parameters' device: a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import _rebuild, leaves, tree_map
from repro_torch.core.aggregators import Arrival, make_aggregator
from repro_torch.optim.optim import Optimizer

_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


class AFLTrainState(NamedTuple):
    params: Any
    opt_state: Any
    afl: Any                # the rule's server state (a dict of tensors)
    step: torch.Tensor      # server iteration t, 0-d int32


def _rule(cfg, backend: Optional[str]):
    """`cfg`'s rule; ``backend="torch"`` sends its cache to the kernels'
    plain versions on any device (rules without a cache have none)."""
    agg = make_aggregator(cfg)
    if backend is not None and hasattr(agg, "backend"):
        agg = dataclasses.replace(agg, backend=backend)
    return agg


def init_afl_state(cfg, grads_like, init_grads=None,
                   backend: Optional[str] = None):
    """Tree-layout server state for `cfg.algorithm` over the parameter
    structure `grads_like`, on its device: `Aggregator.init_state` with the
    structure as the template (the code path the engines take). `init_grads`,
    a structure whose leaves lead with (n,), seeds the cache of a cache-init
    rule; asgd and delay_asgd keep no state."""
    return _rule(cfg, backend).init_state(cfg.n_clients, grads_like,
                                          init_grads,
                                          leaves(grads_like)[0].device)


def apply_server_rule(cfg, afl_state, grads, client, t, staleness,
                      backend: Optional[str] = None):
    """-> (new_afl_state, update (grads-like, f32), lr_scale).

    A thin adapter over `Aggregator.step`: the ``emit`` gate folds into the
    update as an f32 multiply (an arrival that does not flush emits a zero
    update and leaves w unchanged; the train step applies it
    unconditionally)."""
    state, u, emit, scale = _rule(cfg, backend).step(
        afl_state, Arrival(client, grads, t, staleness))
    dev = leaves(grads)[0].device
    gate = torch.as_tensor(emit, device=dev).float()
    return state, tree_map(lambda x: x.float() * gate, u), scale


def make_afl_train_step(loss_fn: Callable, cfg, opt: Optimizer,
                        backend: Optional[str] = None):
    """``loss_fn(params, batch) -> 0-d loss``. Returns ``(init_fn,
    step_fn)``: ``init_fn(params) -> AFLTrainState`` and ``step_fn(state,
    batch, client, staleness) -> (state, metrics)``, the metrics ``loss``,
    ``grad_norm``, ``update_norm`` and ``lr_scale`` as 0-d tensors.
    ``backend="torch"`` runs the rule's cache through the plain versions of
    the kernels (the comparison on the card)."""

    def init_fn(params):
        return AFLTrainState(params=params, opt_state=opt.init(params),
                             afl=init_afl_state(cfg, params, backend=backend),
                             step=torch.zeros((), dtype=torch.int32,
                                              device=leaves(params)[0].device))

    def step_fn(state: AFLTrainState, batch, client, staleness):
        xs = [p.detach().requires_grad_(True) for p in leaves(state.params)]
        with torch.enable_grad():
            loss = loss_fn(_rebuild(state.params, iter(xs)), batch)
            grads = _rebuild(state.params,
                             iter(torch.autograd.grad(loss, xs)))
        with torch.no_grad():
            new_afl, u, scale = apply_server_rule(
                cfg, state.afl, grads, client, state.step, staleness, backend)
            scaled = tree_map(lambda x: (scale * x).float(), u)
            updates, new_opt = opt.update(scaled, state.opt_state,
                                          state.params)
            new_params = tree_map(lambda p, d: (p + d).to(p.dtype),
                                  state.params, updates)
            metrics = {"loss": loss.detach(),
                       "grad_norm": optax_global_norm(grads),
                       "update_norm": optax_global_norm(u),
                       "lr_scale": torch.as_tensor(scale, dtype=torch.float32,
                                                   device=loss.device)}
        return (AFLTrainState(new_params, new_opt, new_afl, state.step + 1),
                metrics)

    return init_fn, step_fn


def optax_global_norm(tree) -> torch.Tensor:
    """The f32 global L2 norm of a structure's leaves (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _numel(params) -> int:
    return sum(int(np.prod(tuple(x.shape), dtype=np.int64))
               for x in leaves(params))


def afl_state_bytes(cfg, params, layout: str = "flat", guards: bool = False,
                    resync_every: Optional[int] = None) -> int:
    """Server-state bytes (paper Table a.3) without allocating: exactly
    what the rule's ``init_state`` allocates — the JAX package's count.

    layout="flat": over the raveled d — a `FlatCache` always carries an
    (n,) f32 scale row, counts are int32 scalars, ACED's t_start is (n,)
    int32, and u / h_bar / accum are f32. layout="tree": over the parameter
    structure — an int8 tree cache carries one (n,) f32 scale a leaf (a
    float one none), and u / h_bar / accum are in cfg.state_dtype.
    ``cfg.k_batch > 1`` sizes ACED's owner-ring (tau_algo+2, k_batch).
    ``guards`` adds the three int32 guard counters and ``resync_every`` the
    int32 emitted-update count, both carried (and checkpointed) with the
    rule's state."""
    db = _BYTES[cfg.cache_dtype]
    d = _numel(params)
    n = cfg.n_clients
    a = cfg.algorithm
    extra = (3 * 4 if guards else 0) + (4 if resync_every else 0)
    if layout == "flat":
        cache = n * d * db + n * 4
        vec = d * 4
    elif layout == "tree":
        n_leaves = len(leaves(params))
        cache = n * d * db + (n * 4 * n_leaves if cfg.cache_dtype == "int8"
                              else 0)
        vec = d * _BYTES[cfg.state_dtype]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    count = 4
    if a == "ace":
        return cache + vec + extra
    if a == "ace_direct":
        return cache + extra
    if a == "aced":
        # t_start (n,) int32, the owner-ring (tau_algo+2, cohort) int32,
        # asum and init_sum, count/t_prev/init_count int32, init_mask (n,)
        cohort = max(1, getattr(cfg, "k_batch", 1))
        return (cache + n * 4 + (cfg.tau_algo + 2) * cohort * 4 + 2 * vec
                + 3 * 4 + n * 1 + extra)
    if a == "aced_direct":
        return cache + n * 4 + extra
    if a == "ca2fl":
        return cache + 3 * vec + count + extra
    if a == "ca2fl_direct":
        return cache + 2 * vec + count + extra
    if a == "fedbuff":
        return vec + count + extra
    return extra


def history_ring_bytes(params, tau_max: int, history_dtype: str = "float32",
                       layout: str = "tree") -> int:
    """Bytes of the staleness engine's (tau_max+1, ·) model-history ring,
    without allocating: layout="tree" is `init_tree_cache(tau_max+1,
    params, history_dtype)` (an int8 ring adds one (S,) f32 scale a leaf),
    layout="flat" one (S, d) f32 leaf."""
    S = tau_max + 1
    d = _numel(params)
    if layout == "flat":
        return S * d * 4
    if layout != "tree":
        raise ValueError(f"unknown layout {layout!r}")
    n_leaves = len(leaves(params))
    return S * d * _BYTES[history_dtype] + (
        S * 4 * n_leaves if history_dtype == "int8" else 0)
