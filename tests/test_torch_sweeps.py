"""The port's seed sweeps and lr × seed grids on the CPU: against the port's
own single runs (bit for bit: a sweep is one runner called once per cell)
and against the JAX package's `run_staleness_seeds` / `run_staleness_grid`
on the same per-seed streams and fault schedules (replayed as
`tests/test_torch_engine.py` replays the streams), within 1e-5 per cell —
the contracts of `tests/test_scan_staleness.py`'s sweep tests, faults
included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import build_fault_schedule as jax_schedule  # noqa: E402
from repro.core.scan_staleness import run_staleness_grid as jax_grid  # noqa: E402
from repro.core.scan_staleness import run_staleness_seeds as jax_seeds  # noqa: E402
from repro_torch.core import (build_fault_schedule,  # noqa: E402
                              make_staleness_runner, run_staleness_grid,
                              run_staleness_scan, run_staleness_seeds)
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core.scan_staleness import (FaultSchedule,  # noqa: E402
                                             eval_marks_for)
from test_torch_engine import WINDOWS, N, D, _make, quadratic, replay_streams  # noqa: E402

T, BETA, SEEDS = 18, 2.0, (1, 2)
RATES = dict(nan_rate=0.08, explode_rate=0.05, byzantine_rate=0.05,
             overstale_rate=0.08)
CLIP = 5.0


def _centre():
    """The mean of the quadratic testbed's client optima."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(N, D))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (dirs * 3.0).astype(np.float32).mean(0)


def _eval(lib):
    c = _centre()
    if lib == "jax":
        return lambda p: {"dist": float(jnp.linalg.norm(p - c))}
    ct = torch.as_tensor(c)
    return lambda p: {"dist": float(torch.linalg.vector_norm(p - ct))}


def _n_events(agg):
    return default_n_events(agg, T) + 40 + N


def _same(a, b):
    """Two port results bit for bit."""
    assert np.array_equal(a.w, b.w)
    assert np.array_equal(a.emit, b.emit) and np.array_equal(a.ts, b.ts)
    assert np.array_equal(a.losses, b.losses)
    assert np.array_equal(a.update_norms, b.update_norms)
    assert a.total_comms == b.total_comms and a.faults == b.faults
    assert a.eval_ts == b.eval_ts and a.evals == b.evals


def _close(tr, jr):
    """A port cell against the JAX package's: within 1e-5."""
    assert np.isfinite(tr.w).all()
    assert np.array_equal(tr.emit, jr.emit) and np.array_equal(tr.ts, jr.ts)
    assert tr.total_comms == jr.total_comms and tr.faults == jr.faults
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-5)
    assert tr.eval_ts == jr.eval_ts
    for a, b in zip(tr.evals, jr.evals):
        assert abs(a["dist"] - b["dist"]) <= 1e-5


def _port_kw(name, dtype, K):
    _, torch_grad, _ = quadratic()
    return dict(grad_fn=torch_grad, params0=torch.ones(D),
                aggregator=_make(name, dtype, K, "torch"), n_clients=N, T=T,
                beta=BETA, tau_max=6, windows=WINDOWS, k_batch=K,
                n_events=_n_events(_make(name, dtype, K, "torch")),
                device="cpu")


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "int8", 4),
                                          ("ca2fl", "float32", 1)])
def test_seeds_equal_single_runs(name, dtype, K):
    """A faulted seed sweep (per-seed schedules, a clip, a resync cadence,
    an eval cadence) against `run_staleness_scan` with each seed and that
    seed's schedule: bit for bit."""
    kw = _port_kw(name, dtype, K)
    E = kw["n_events"]
    sweep = run_staleness_seeds(seeds=SEEDS, server_lr=0.1,
                                fault_rates=RATES, clip_norm=CLIP,
                                resync_every=4, eval_fn=_eval("torch"),
                                eval_every=7, **kw)
    assert len(sweep) == len(SEEDS)
    for s, got in zip(SEEDS, sweep):
        fa = build_fault_schedule(s, E, k_batch=K, device="cpu", **RATES)
        _same(got, run_staleness_scan(seed=s, server_lr=0.1, faults=fa,
                                      clip_norm=CLIP, resync_every=4,
                                      eval_fn=_eval("torch"), eval_every=7,
                                      **kw))
        assert set(got.faults) == {"quarantined", "clipped", "rejected"}
        assert sum(got.faults.values()) > 0 and np.isfinite(got.w).all()
    # each seed draws its own streams and schedule
    assert not np.array_equal(sweep[0].w, sweep[1].w)


@pytest.mark.parametrize("faulted", [False, True])
def test_grid_equals_single_runs(faulted):
    """results[i_lr][i_seed] of a 3 × 2 grid against `run_staleness_scan`
    with that seed and lr: bit for bit, and a callable server_lr through
    `run_staleness_seeds` ends where the same schedule ends alone."""
    kw = _port_kw("aced", "int8", 1)
    E = kw["n_events"]
    lrs = (0.05, 0.1, 0.2)
    guard = dict(fault_rates=RATES, clip_norm=CLIP) if faulted else {}
    grid = run_staleness_grid(lrs=lrs, seeds=SEEDS, **guard, **kw)
    assert len(grid) == len(lrs) and all(len(r) == len(SEEDS) for r in grid)
    for i, lr in enumerate(lrs):
        for j, s in enumerate(SEEDS):
            one = ({"faults": build_fault_schedule(s, E, device="cpu",
                                                   **RATES),
                    "clip_norm": CLIP} if faulted else {})
            _same(grid[i][j], run_staleness_scan(seed=s, server_lr=lr,
                                                 **one, **kw))
    assert not np.array_equal(grid[0][0].w, grid[2][0].w)
    schedule = lambda t: 0.2 / (1.0 + 0.1 * t)   # noqa: E731
    _same(run_staleness_seeds(seeds=SEEDS[:1], server_lr=schedule, **guard,
                              **kw)[0],
          run_staleness_scan(seed=SEEDS[0], server_lr=schedule, **(
              {"faults": build_fault_schedule(SEEDS[0], E, device="cpu",
                                              **RATES), "clip_norm": CLIP}
              if faulted else {}), **kw))


def test_a_runner_is_reused_when_its_statics_match():
    """A `runner=` whose guards, resync cadence, eval marks and k_batch
    match the sweep's serves it (the same results as a sweep that builds
    its own); one that differs raises."""
    kw = _port_kw("ace", "int8", 1)
    runner = make_staleness_runner(
        grad_fn=kw["grad_fn"], params0=kw["params0"],
        aggregator=kw["aggregator"], n_clients=N, T=T, beta=BETA, tau_max=6,
        guards=True, resync_every=4, eval_marks=eval_marks_for(T, 7),
        device="cpu")
    sweep_kw = dict(fault_rates=RATES, clip_norm=CLIP, resync_every=4,
                    eval_fn=_eval("torch"), eval_every=7)
    reused = run_staleness_grid(lrs=(0.1, 0.2), seeds=SEEDS, runner=runner,
                                **sweep_kw, **kw)
    own = run_staleness_grid(lrs=(0.1, 0.2), seeds=SEEDS, **sweep_kw, **kw)
    for a, b in zip(sum(reused, []), sum(own, [])):
        _same(a, b)
    assert runner.captures == 0                   # eager on the CPU
    for other in (dict(sweep_kw, resync_every=None),
                  dict(sweep_kw, fault_rates=None, clip_norm=0.0),
                  dict(sweep_kw, eval_every=5)):
        with pytest.raises(ValueError, match="runner built with"):
            run_staleness_seeds(seeds=SEEDS, server_lr=0.1, runner=runner,
                                **other, **kw)


def _jax_replays(name, dtype, K, E, faulted):
    """The JAX sweep's per-seed streams and schedules as the port's lists
    (``randomness=``, ``payload_noise=``, ``faults=``)."""
    _, _, noise_of = quadratic()
    rands, noises, faults = [], [], []
    for s in SEEDS:
        rand, noise = replay_streams(
            s, E, N, BETA, K, noise_of, (D,),
            jagg.wants_cache_init(_make(name, dtype, K, "jax")),
            windows=WINDOWS)
        rands.append(rand)
        noises.append(noise)
        if faulted:
            fa = jax_schedule(s, E, k_batch=K, **RATES)
            faults.append(FaultSchedule(torch.as_tensor(np.array(fa.kind)),
                                        torch.as_tensor(np.array(fa.scale))))
    return dict(randomness=rands, payload_noise=noises,
                faults=faults if faulted else None)


def _jax_kw(name, dtype, K, E):
    jax_grad, _, _ = quadratic()
    return dict(grad_fn=jax_grad, params0=jnp.ones(D),
                aggregator=_make(name, dtype, K, "jax"), n_clients=N, T=T,
                beta=BETA, tau_max=6, windows=WINDOWS, k_batch=K, n_events=E,
                seeds=SEEDS)


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "int8", 4),
                                          ("ca2fl", "float32", 1)])
def test_faulted_seeds_match_jax(name, dtype, K):
    """A faulted seed sweep with a clip, a resync cadence and an eval
    cadence: each seed within 1e-5 of the JAX package's vmapped sweep, the
    same emissions and guard counters."""
    kw = _port_kw(name, dtype, K)
    E = kw["n_events"]
    guard = dict(fault_rates=RATES, clip_norm=CLIP, resync_every=4,
                 eval_every=7)
    jr = jax_seeds(server_lr=0.1, eval_fn=_eval("jax"), **guard,
                   **_jax_kw(name, dtype, K, E))
    tr = run_staleness_seeds(seeds=SEEDS, server_lr=0.1,
                             eval_fn=_eval("torch"), **guard,
                             **_jax_replays(name, dtype, K, E, True), **kw)
    for a, b in zip(tr, jr):
        _close(a, b)
        assert sum(a.faults.values()) > 0


@pytest.mark.parametrize("faulted", [False, True])
def test_grid_matches_jax(faulted):
    """A 3 × 2 lr × seed grid (int8 ACED, K = 1): every cell within 1e-5 of
    the JAX package's nested-vmap grid."""
    kw = _port_kw("aced", "int8", 1)
    E = kw["n_events"]
    lrs = (0.05, 0.1, 0.2)
    guard = dict(fault_rates=RATES, clip_norm=CLIP) if faulted else {}
    jr = jax_grid(lrs=lrs, eval_fn=_eval("jax"), eval_every=7, **guard,
                  **_jax_kw("aced", "int8", 1, E))
    tr = run_staleness_grid(lrs=lrs, seeds=SEEDS, eval_fn=_eval("torch"),
                            eval_every=7, **guard,
                            **_jax_replays("aced", "int8", 1, E, faulted),
                            **kw)
    for row_t, row_j in zip(tr, jr):
        for a, b in zip(row_t, row_j):
            _close(a, b)


def test_sweep_replays_are_checked():
    """Per-seed lists of another length than `seeds` raise, as does a
    replayed stream of another event count than the sweep's cells."""
    kw = _port_kw("ace", "int8", 1)
    E = kw["n_events"]
    replays = _jax_replays("ace", "int8", 1, E, False)
    with pytest.raises(ValueError, match="entries"):
        run_staleness_seeds(seeds=SEEDS, server_lr=0.1,
                            randomness=replays["randomness"][:1], **kw)
    short = dict(replays, randomness=[replays["randomness"][0],
                                      replays["randomness"][1].slice(0, 20)])
    with pytest.raises(ValueError, match="events"):
        run_staleness_seeds(seeds=SEEDS, server_lr=0.1, **short, **kw)
