"""The port's event-driven engine (`repro_torch.core.scan_engine`) against the
JAX package's (`repro.core.scan_engine`) on the same schedule and the same
payload noise: the JAX key chain (one split per init client, then one per
event) replayed into the port's `PayloadNoise`.

  * `build_schedule` / `arrival_schedule` give JAX's arrays (both are host
    numpy copies);
  * `run_scan` on the quadratic testbed — asgd, fedbuff, ca2fl, ace, aced
    × f32/int8 at full and limited concurrency — and on the vision task at
    reduced width: emission, iterations and comms equal, the model after
    every event within 1e-5;
  * `run_scan_seeds` equals single runs bit for bit, `sweep` runs every
    algorithm, and the MSE diagnostics equal JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import delays as jdelays  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core import mse as jmse  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_engine import run_scan as jax_scan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import delays as tdelays  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core import mse as tmse  # noqa: E402
from repro_torch.core.scan_engine import (  # noqa: E402
    build_payload_noise, make_scan_runner, run_scan, run_scan_seeds, sweep)
from test_torch_engine import (VISION, D, N, jax_vision_grad,  # noqa: E402
                               quadratic, replay_streams)


def scan_noise(seed, n_events, n, noise_of, noise_shape, wants_init):
    """The payload noise JAX's `run_scan` draws for `seed`, as the port's
    `PayloadNoise` (its key chain is the staleness engine's at K = 1)."""
    return replay_streams(seed, n_events, n, 2.0, 1, noise_of, noise_shape,
                          wants_init)[1]


@pytest.mark.parametrize("concurrency", [None, 3])
def test_build_schedule_matches_jax(concurrency):
    for seed, kappa in ((0, 0.0), (4, 4.0)):
        jd = jdelays.ExponentialDelays(beta=2.0, kappa=kappa, n_clients=9,
                                       seed=seed)
        td = tdelays.ExponentialDelays(beta=2.0, kappa=kappa, n_clients=9,
                                       seed=seed)
        a = jdelays.build_schedule(jd, 300, concurrency, seed)
        b = tdelays.build_schedule(td, 300, concurrency, seed)
        assert np.array_equal(a.arrive, b.arrive)
        assert np.array_equal(a.dispatch, b.dispatch)
        assert b.n_events == 300 and b.arrive.dtype == np.int32
        assert np.array_equal(
            jdelays.arrival_schedule(jd, 50, concurrency, seed),
            tdelays.arrival_schedule(td, 50, concurrency, seed))
        # a schedule never consumes the caller's delay stream
        assert jd.sample(0) == td.sample(0)


def _rule(name, dtype, lib):
    mod = tagg if lib == "torch" else jagg
    if name == "asgd":
        return mod.VanillaASGD()
    if name == "fedbuff":
        return mod.FedBuff(buffer_size=3)
    if name == "ca2fl":
        return mod.CA2FL(buffer_size=3, cache_dtype=dtype)
    if name == "ace":
        return mod.ACEIncremental(cache_dtype=dtype)
    return mod.ACED(tau_algo=4, cache_dtype=dtype)


QUAD_CASES = ([(r, "float32") for r in ("asgd", "fedbuff")]
              + [(r, dt) for r in ("ca2fl", "ace", "aced")
                 for dt in ("float32", "int8")])


def _both(grads, params0, name, dtype, T, seed, concurrency, n, noise_of,
          noise_shape, lr):
    """(JAX result, port result) of `run_scan` on the same schedule and
    payload noise, the model recorded after every event."""
    jax_grad, torch_grad = grads
    j_agg = _rule(name, dtype, "jax")
    n_events = default_n_events(j_agg, T)
    kw = dict(n_clients=n, server_lr=lr, T=T, concurrency=concurrency,
              seed=seed, record_w=True)
    jr = jax_scan(grad_fn=jax_grad, params0=params0[0], aggregator=j_agg,
                  delays=jdelays.ExponentialDelays(beta=2.0, kappa=2.0,
                                                   n_clients=n, seed=seed),
                  **kw)
    noise = scan_noise(seed, n_events, n, noise_of, noise_shape,
                       jagg.wants_cache_init(j_agg))
    tr = run_scan(grad_fn=torch_grad, params0=params0[1],
                  aggregator=_rule(name, dtype, "torch"),
                  delays=tdelays.ExponentialDelays(beta=2.0, kappa=2.0,
                                                   n_clients=n, seed=seed),
                  device="cpu", payload_noise=noise, **kw)
    return jr, tr


@pytest.mark.parametrize("concurrency", [None, 3])
@pytest.mark.parametrize("name,dtype", QUAD_CASES)
def test_run_scan_matches_jax(name, dtype, concurrency):
    """The quadratic testbed (paper Fig. 2), speed-skewed delays: emission,
    iterations and comms equal, and the model after every event within
    1e-5 of JAX's."""
    jax_grad, torch_grad, noise_of = quadratic()
    jr, tr = _both((jax_grad, torch_grad), (jnp.ones(D), torch.ones(D)),
                   name, dtype, 14, 2, concurrency, N, noise_of, (D,), 0.1)
    assert np.array_equal(tr.emit, np.asarray(jr.emit))
    assert np.array_equal(tr.ts, jr.ts) and len(tr.ts) > 0
    assert tr.total_comms == jr.total_comms
    assert np.max(np.abs(tr.ws - np.asarray(jr.ws))) <= 1e-5
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,dtype", [("ace", "int8"), ("aced", "float32"),
                                        ("ca2fl", "int8")])
def test_run_scan_vision_matches_jax(name, dtype):
    """The vision task at reduced widths (d = 370) on the event engine:
    final model and per-update losses within 1e-5."""
    jtask = jtasks.make_vision_task(**VISION)
    ttask = ttasks.make_vision_task(**VISION, device="cpu")
    jgrad, noise_of = jax_vision_grad(VISION)
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    jr, tr = _both((jgrad, ttask.grad_fn), (jtask.params0, params0), name,
                   dtype, 12, 1, None, VISION["n_clients"], noise_of,
                   (VISION["batch"],), 0.2)
    assert tr.w.shape == (370,) and np.isfinite(tr.w).all()
    assert np.array_equal(tr.emit, np.asarray(jr.emit))
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-5)


def test_ace_int8_invariant_under_the_event_engine():
    """After any sequence of events, ACE's running mean equals the mean of
    the dequantized int8 cache (paper Alg. a.5)."""
    _, torch_grad, _ = quadratic()
    agg = tagg.ACEIncremental(cache_dtype="int8")
    runner = make_scan_runner(grad_fn=torch_grad, params0=torch.ones(D),
                              aggregator=agg, n_clients=N, server_lr=0.1,
                              T=20, device="cpu")
    sched = tdelays.build_schedule(
        tdelays.ExponentialDelays(beta=2.0, n_clients=N, seed=5), 19)
    _, state, outs = runner(sched.arrive, sched.dispatch,
                            build_payload_noise(torch_grad, 5, 19, N,
                                                device="cpu"))
    cache = state["cache"]
    mean = (cache.data.float() * cache.scale[:, None]).mean(0)
    assert torch.allclose(state["u"], mean, rtol=1e-4, atol=1e-5)
    assert bool(outs["emit"].all())


def test_run_scan_seeds_equal_single_runs():
    """One runner called per seed: each seed's run equals `run_scan` with
    that seed bit for bit, and a runner passed in serves another call."""
    _, torch_grad, _ = quadratic()
    seeds = (1, 2, 3)
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
              server_lr=0.1, T=12, device="cpu")
    batch = run_scan_seeds(aggregator=tagg.ACED(tau_algo=4,
                                                cache_dtype="int8"),
                           seeds=seeds, beta=2.0, kappa=1.0, **kw)
    for s, r in zip(seeds, batch):
        single = run_scan(aggregator=tagg.ACED(tau_algo=4, cache_dtype="int8"),
                          delays=tdelays.ExponentialDelays(
                              beta=2.0, kappa=1.0, n_clients=N, seed=s),
                          seed=s, **kw)
        assert np.array_equal(r.w, single.w)
        assert np.array_equal(r.emit, single.emit)
        assert np.array_equal(r.losses, single.losses)
    agg = tagg.ACEIncremental()
    runner = make_scan_runner(aggregator=agg, checkify_invariants=False,
                              **kw)
    again = run_scan_seeds(aggregator=agg, seeds=seeds[:2], beta=2.0,
                           kappa=1.0, runner=runner, **kw)
    fresh = run_scan_seeds(aggregator=agg, seeds=seeds[:2], beta=2.0,
                           kappa=1.0, **kw)
    assert all(np.array_equal(a.w, b.w) for a, b in zip(again, fresh))


def test_sweep_runs_all_algorithms():
    _, torch_grad, _ = quadratic()
    rows = sweep(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
                 server_lr=0.1, T=10, seeds=(0, 1), beta=2.0, buffer_size=3,
                 cache_dtype="int8", device="cpu")
    assert set(rows) == {"asgd", "fedbuff", "ca2fl", "ace", "aced"}
    for name, row in rows.items():
        assert row["algo"] == name and row["seeds"] == 2
        assert np.isfinite(row["final_loss_mean"]), name
        assert row["wall_s"] > 0 and row["compile_s"] >= 0
        assert len(row["results"]) == 2
        assert all(r.ts.size > 0 for r in row["results"])


def test_mse_decomposition_matches_jax():
    rng = np.random.default_rng(0)
    u, ub, gs, gn = rng.normal(size=(4, 7))
    assert tmse.decompose(u, ub, gs, gn) == jmse.decompose(u, ub, gs, gn)
    rows = rng.normal(size=(5, 7))
    assert np.array_equal(tmse.expected_update_ace(rows),
                          jmse.expected_update_ace(rows))
    assert np.array_equal(tmse.expected_update_subset(rows, [0, 3]),
                          jmse.expected_update_subset(rows, [0, 3]))
    C = rng.normal(size=(5, 7))
    stale = rng.normal(size=(5, 7))
    fn = lambda i, w: w - C[i]
    assert np.array_equal(tmse.grad_f_stale(fn, stale),
                          jmse.grad_f_stale(fn, stale))
