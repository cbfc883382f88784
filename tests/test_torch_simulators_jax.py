"""The port's host references against the JAX package's
(`repro.core.simulator.AFLSimulator`, `repro.core.staleness_sim.
StalenessSimulator`) on the same inputs: the same data and initial model,
JAX's protocol stream (`build_staleness_randomness`, handed to both
through ``replay=``) and JAX's payload key chain replayed into the port's
`PayloadNoise` (`tests/test_torch_engine.py::replay_streams`: one split
per payload call, ``split(key, K+1)`` then one split per lane for K > 1
ticks — the chain JAX's host loop walks, its frozen ticks included).

  * `StalenessSimulator`, replay mode: the five rules at K ∈ {1, 4} on the
    quadratic testbed with a window that freezes and thaws the run, faulted
    runs (with clip and resync) at K = 1 and 4, and the vision task at
    reduced width.
  * `StalenessSimulator`, non-replay: the numpy draws of both packages give
    the same clients and `ts` exactly (legacy dropout and speed skew
    included).
  * `AFLSimulator` on speed-skewed delays, full and limited concurrency.

Tolerances: the final model within 1e-5, losses and update norms within
rtol 1e-5 on the vision task; `ts`, uploads and guard counters identical.
JAX's kernels run as its own CPU tests run them.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import delays as jdelays  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core.scan_staleness import build_fault_schedule as jax_schedule  # noqa: E402
from repro.core.simulator import AFLSimulator as JaxAFL  # noqa: E402
from repro.core.staleness_sim import StalenessSimulator as JaxSim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import AFLSimulator, StalenessSimulator  # noqa: E402
from repro_torch.core import delays as tdelays  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.fl_tasks import ClientGrad  # noqa: E402
from test_torch_engine import (VISION, WINDOWS, D, N,  # noqa: E402
                               _make_zoo, jax_vision_grad, quadratic,
                               replay_streams)
from test_torch_faults import _port  # noqa: E402
from test_torch_scan_engine import scan_noise  # noqa: E402

T, BETA, LR, SEED, TAU_MAX = 18, 2.0, 0.1, 3, 6
# one event count for every run of a kind, so that JAX compiles each
# stream's shapes once: enough for FedBuff's buffer of 2, the windows'
# freeze and the faulted runs' quarantined and rejected events
E_STALENESS, E_VISION, E_EVENT = 100, 24, 40
RULES = ("asgd", "fedbuff", "ca2fl", "ace", "aced")
RATES = dict(nan_rate=0.08, explode_rate=0.05, byzantine_rate=0.05,
             overstale_rate=0.08)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops are slow with many intra-op threads on a shared host;
    the runs here are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jitted(agg):
    """A JAX rule whose transitions run compiled, as JAX's engines run
    them: its host loop calls them op by op, which compiles every
    primitive anew."""
    for name in ("step", "step_batch", "resync"):
        setattr(agg, name, jax.jit(getattr(agg, name)))
    return agg


@functools.lru_cache(maxsize=1)
def _quadratic():
    """The testbed, JAX's gradient compiled once for the module."""
    jax_grad, torch_grad, noise_of = quadratic()
    return jax.jit(jax_grad), torch_grad, noise_of


@functools.lru_cache(maxsize=1)
def _vision():
    """Both vision tasks at reduced width and JAX's gradient compiled."""
    jgrad, noise_of = jax_vision_grad(VISION)
    return (jtasks.make_vision_task(**VISION),
            ttasks.make_vision_task(**VISION, device="cpu"), jax.jit(jgrad),
            noise_of)


def _dtype(name):
    return "int8" if name in ("ca2fl", "ace", "aced") else "float32"


def _agree(jsim, jr, tsim, tr, tol=1e-5):
    assert np.isfinite(tsim.w.numpy()).all()
    assert np.max(np.abs(tsim.w.numpy() - np.asarray(jsim.w))) <= tol
    assert tr.ts == [int(t) for t in jr.ts]
    assert tr.total_comms == jr.total_comms
    assert tr.faults == jr.faults
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)


def _staleness_pair(name, K, *, faults=False, clip_norm=0.0,
                    resync_every=None):
    """The same replayed run of both host simulators (windows freezing the
    run at t = 6 and thawing it at 10)."""
    jax_grad, torch_grad, noise_of = _quadratic()
    j_agg = _jitted(_make_zoo(name, _dtype(name), K, "jax"))
    rand, noise = replay_streams(SEED, E_STALENESS, N, BETA, K, noise_of, (D,),
                                 jagg.wants_cache_init(j_agg),
                                 windows=WINDOWS)
    jf = (jax_schedule(SEED, E_STALENESS, k_batch=K, **RATES) if faults
          else None)
    kw = dict(n_clients=N, server_lr=LR, beta=BETA, tau_max=TAU_MAX,
              seed=SEED, k_batch=K, clip_norm=clip_norm,
              resync_every=resync_every)
    jsim = JaxSim(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                  replay=rand, faults=jf, **kw)
    jr = jsim.run(T)
    tsim = StalenessSimulator(
        grad_fn=torch_grad, params0=torch.ones(D),
        aggregator=_make_zoo(name, _dtype(name), K, "torch"), replay=rand,
        payload_noise=noise, faults=_port(jf) if faults else None,
        device="cpu", **kw)
    return jsim, jr, tsim, tsim.run(T)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", RULES)
def test_staleness_sim_matches_jax(name, K):
    jsim, jr, tsim, tr = _staleness_pair(name, K)
    assert np.any(np.diff(tr.ts) > 1)          # the freeze and the thaw
    _agree(jsim, jr, tsim, tr)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_faulted_staleness_sim_matches_jax(name, K):
    """JAX's fault schedule carried across: quarantine, clip, over-stale
    rejection and resync every 4 updates, identical counters."""
    jsim, jr, tsim, tr = _staleness_pair(name, K, faults=True,
                                         clip_norm=5.0, resync_every=4)
    assert sum(tr.faults.values()) > 0
    _agree(jsim, jr, tsim, tr)


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "float32", 4),
                                          ("ca2fl", "int8", 4)])
def test_vision_staleness_sim_matches_jax(name, dtype, K):
    """The vision task at reduced width (d = 370), the eval cadence
    included: model, losses and accuracies."""
    T_, beta, seed, lr = 12, 2.0, 1, 0.2
    jtask, ttask, jgrad, noise_of = _vision()
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    j_agg = _jitted(_make_zoo(name, dtype, K, "jax"))
    n = VISION["n_clients"]
    rand, noise = replay_streams(seed, E_VISION, n, beta, K, noise_of,
                                 (VISION["batch"],),
                                 jagg.wants_cache_init(j_agg))
    kw = dict(n_clients=n, server_lr=lr, beta=beta, seed=seed, k_batch=K,
              eval_every=5)
    jsim = JaxSim(grad_fn=jgrad, params0=jtask.params0, aggregator=j_agg,
                  eval_fn=jtask.eval_fn, replay=rand, **kw)
    jr = jsim.run(T_)
    tsim = StalenessSimulator(
        grad_fn=ttask.grad_fn, params0=params0,
        aggregator=_make_zoo(name, dtype, K, "torch"), eval_fn=ttask.eval_fn,
        replay=rand, payload_noise=noise, device="cpu", **kw)
    tr = tsim.run(T_)
    assert tsim.w.shape == (370,)
    _agree(jsim, jr, tsim, tr)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-5)
    assert tr.eval_ts == jr.eval_ts == [5, 10, 12]
    for te, je in zip(tr.evals, jr.evals):
        assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-6)


@pytest.mark.parametrize("name", ["asgd", "aced"])
def test_non_replay_draws_match_jax(name):
    """Non-replay mode: both packages draw j and τ from
    ``np.random.default_rng(seed)`` (the legacy dropout set too), so the
    clients and `ts` are JAX's exactly; the payload noise is JAX's key
    chain, one call per event."""
    jax_grad, torch_grad, noise_of = _quadratic()
    j_agg = _jitted(_make_zoo(name, "int8", 1, "jax"))
    _, noise = replay_streams(SEED, E_EVENT, N, BETA, 1, noise_of, (D,),
                              jagg.wants_cache_init(j_agg))
    seen = {"jax": [], "torch": []}

    def jspy(params, client, key):
        seen["jax"].append(int(client))
        return jax_grad(params, client, key)

    def tspy(w, clients, noise_):
        seen["torch"].extend(clients.tolist())
        return torch_grad(w, clients, noise_)

    kw = dict(n_clients=N, server_lr=LR, beta=BETA, seed=SEED,
              speed_skew=1.5, dropout_frac=0.5, dropout_at=12)
    jsim = JaxSim(grad_fn=jspy, params0=jnp.ones(D), aggregator=j_agg, **kw)
    jr = jsim.run(30)
    tsim = StalenessSimulator(
        grad_fn=ClientGrad(tspy, (D,), "normal"), params0=torch.ones(D),
        aggregator=_make_zoo(name, "int8", 1, "torch"), payload_noise=noise,
        device="cpu", **kw)
    tr = tsim.run(30)
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) >= 29
    _agree(jsim, jr, tsim, tr)


@pytest.mark.parametrize("concurrency", [None, 3])
@pytest.mark.parametrize("name", RULES)
def test_afl_sim_matches_jax(name, concurrency):
    jax_grad, torch_grad, noise_of = _quadratic()
    j_agg = _jitted(_make_zoo(name, _dtype(name), 1, "jax"))
    seed, T_ = 2, 14
    noise = scan_noise(seed, E_EVENT, N, noise_of, (D,),
                       jagg.wants_cache_init(j_agg))
    kw = dict(n_clients=N, server_lr=LR, concurrency=concurrency, seed=seed)
    jsim = JaxAFL(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                  delays=jdelays.ExponentialDelays(beta=2.0, kappa=2.0,
                                                   n_clients=N, seed=seed),
                  **kw)
    jr = jsim.run(T_)
    tsim = AFLSimulator(
        grad_fn=torch_grad, params0=torch.ones(D),
        aggregator=_make_zoo(name, _dtype(name), 1, "torch"),
        delays=tdelays.ExponentialDelays(beta=2.0, kappa=2.0, n_clients=N,
                                         seed=seed),
        payload_noise=noise, device="cpu", **kw)
    _agree(jsim, jr, tsim, tsim.run(T_))
