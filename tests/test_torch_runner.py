"""The port's runners on the CPU: the eval cadence, the chunked runner and
the runtime lr against the JAX package's `run_staleness_scan` on the same
random streams (replayed as `tests/test_torch_engine.py` replays them), and
the runners against the port's own single run. Also the engine's remaining
differential cases against JAX: K = 16 on 20 clients, a callable
server_lr, several local steps, speed skew and a bf16 cache.

Tolerances: 1e-5 against the JAX package (the repo's contract between its
engines); bit for bit where the port is compared with itself (the chunked
runner, a runner called twice). The graph path itself needs the card: its
tests are in `tests/test_torch_cuda.py` (``-k graph``).
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import eval_marks_for as jax_marks  # noqa: E402
from repro.core.scan_staleness import run_staleness_scan as jax_run  # noqa: E402
from repro_torch.core import (ChunkedStalenessRunner,  # noqa: E402
                              FlatCache, make_chunked_staleness_runner,
                              make_staleness_runner)
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.scan_staleness import (  # noqa: E402
    build_payload_noise, build_staleness_randomness, eval_marks_for)
from repro_torch.core.scan_staleness import run_staleness_scan as torch_run  # noqa: E402
from test_torch_engine import (WINDOWS, N, D, _make, quadratic,  # noqa: E402
                               replay_streams)


def test_eval_marks_for_cadence():
    """The JAX package's cases, and the same marks as its function."""
    assert eval_marks_for(40, 7) == (7, 14, 21, 28, 35, 40)
    assert eval_marks_for(40, 10) == (10, 20, 30, 40)
    assert eval_marks_for(5, 100) == (5,)
    assert eval_marks_for(40, None) is None
    for T, every in ((18, 7), (12, 3), (7, 7)):
        assert eval_marks_for(T, every) == jax_marks(T, every)


def _centre():
    """The mean of the quadratic testbed's client optima (the same C as
    `quadratic()` draws)."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(N, D))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (dirs * 3.0).astype(np.float32).mean(0)


@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_eval_cadence_matches_jax(name):
    """``eval_fn``/``eval_every = 7`` on a run that freezes at t = 6 and
    thaws with a jump to t = 10: both packages evaluate at the marks the
    run reached (7 is skipped by the jump, as the host's modulo cadence
    skips it), on snapshots within 1e-5."""
    T, beta, seed, lr, K = 18, 2.0, 3, 0.1, 1
    jax_grad, torch_grad, noise_of = quadratic()
    c = _centre()
    j_agg, t_agg = _make(name, "int8", K, "jax"), _make(name, "int8", K,
                                                        "torch")
    n_events = default_n_events(j_agg, T) + N
    kw = dict(n_clients=N, server_lr=lr, T=T, beta=beta, tau_max=6,
              n_events=n_events, seed=seed, windows=WINDOWS, eval_every=7)
    jr = jax_run(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                 eval_fn=lambda p: {"dist": float(jnp.linalg.norm(p - c))},
                 **kw)
    rand, noise = replay_streams(seed, n_events, N, beta, K, noise_of, (D,),
                                 jagg.wants_cache_init(j_agg),
                                 windows=WINDOWS)
    ct = torch.as_tensor(c)
    tr = torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                   aggregator=t_agg, device="cpu", randomness=rand,
                   payload_noise=noise,
                   eval_fn=lambda p: {
                       "dist": float(torch.linalg.vector_norm(p - ct))},
                   **kw)
    assert jr.eval_ts == tr.eval_ts
    assert 7 not in tr.eval_ts and tr.eval_ts[-1] == T
    assert len(tr.evals) == len(tr.eval_ts) >= 2
    for a, b in zip(tr.evals, jr.evals):
        assert abs(a["dist"] - b["dist"]) <= 1e-5
    assert tr.final_eval() == tr.evals[-1]


def _same_state(a, b):
    """Two aggregator states bit for bit (cache rows and scales too)."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], FlatCache):
            assert torch.equal(a[k].data, b[k].data)
            assert torch.equal(a[k].scale, b[k].scale)
        else:
            assert torch.equal(a[k], b[k])


def _quadratic_streams(K, E, seed=5):
    _, torch_grad, _ = quadratic()
    rand = build_staleness_randomness(seed, E, N, 2.0, windows=WINDOWS,
                                      k_batch=K, device="cpu")
    return torch_grad, rand, build_payload_noise(torch_grad, seed, E, N, K,
                                                 device="cpu")


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_chunked_run_matches_one_run(name, dtype, K):
    """Three slices, the second starting at the tick that freezes, the
    carry saved and loaded with torch.save / torch.load between them: the
    chunks end bit for bit where one run ends (model, every state tensor,
    every per-event output), with the same eval snapshots."""
    T, E = 18, 40
    grad, rand, noise = _quadratic_streams(K, E)
    kw = dict(grad_fn=grad, params0=torch.ones(D), n_clients=N, T=T,
              beta=2.0, tau_max=6, k_batch=K, eval_marks=(7, 14, 18),
              record_w=True, device="cpu")
    w, state, outs, extras = make_staleness_runner(
        aggregator=_make(name, dtype, K, "torch"), **kw)(rand, noise, 0.1)
    frozen = int(np.flatnonzero(~outs["alive"].numpy())[0])
    runner = make_chunked_staleness_runner(
        aggregator=_make(name, dtype, K, "torch"), capacity=E, **kw)
    assert isinstance(runner, ChunkedStalenessRunner)
    assert runner.marks == (7, 14, 18) and runner.k_batch == K
    carry, parts = runner.init(0.1, noise.init), []
    for a, b in ((0, frozen), (frozen, frozen + 9), (frozen + 9, E)):
        carry, o = runner.chunk(carry, rand.slice(a, b), noise.ticks[a:b],
                                0.1)
        parts.append(o)
        buf = io.BytesIO()
        torch.save(carry, buf)
        buf.seek(0)
        carry = torch.load(buf)
    assert int(carry["e"]) == E
    assert torch.equal(carry["w"], w)
    _same_state(carry["state"], state)
    for k in outs:
        assert torch.equal(torch.cat([p[k] for p in parts]), outs[k])
    assert torch.equal(carry["snaps"], extras["snaps"])
    assert torch.equal(carry["hits"], extras["hits"])
    with pytest.raises(ValueError, match="slice of"):
        make_chunked_staleness_runner(
            aggregator=_make(name, dtype, K, "torch"), capacity=8,
            **kw).chunk(runner.init(0.1, noise.init), rand.slice(0, 9),
                        noise.ticks[:9], 0.1)


def test_runner_called_with_two_lrs_equals_two_fresh_runs():
    """One runner, two lrs (a number, then a 0-d tensor): each call ends
    bit for bit where a runner built for it alone ends."""
    grad, rand, noise = _quadratic_streams(1, 30)
    kw = dict(grad_fn=grad, params0=torch.ones(D), n_clients=N, T=18,
              beta=2.0, tau_max=6, device="cpu")

    def runner():
        return make_staleness_runner(
            aggregator=tagg.ACED(tau_algo=4, cache_dtype="int8"), **kw)
    r = runner()
    a = r(rand, noise, 0.1)
    b = r(rand, noise, torch.tensor(0.03))
    for got, lr in ((a, 0.1), (b, 0.03)):
        ref = runner()(rand, noise, lr)
        assert torch.equal(got[0], ref[0])
        _same_state(got[1], ref[1])
        assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])
    assert not torch.equal(a[0], b[0])
    assert r.captures == 0                       # eager on the CPU


def test_runner_called_with_two_event_counts_equals_fresh_runs():
    """One runner, 30 events then 20 then 30 again: each call ends bit for
    bit where a runner built for it alone ends."""
    kw = dict(params0=torch.ones(D), n_clients=N, T=18, beta=2.0, tau_max=6,
              device="cpu")

    def runner(grad):
        return make_staleness_runner(
            grad_fn=grad, aggregator=tagg.ACEIncremental(cache_dtype="int8"),
            **kw)
    grad, _, _ = _quadratic_streams(1, 30)
    r = runner(grad)
    for E in (30, 20, 30):
        _, rand, noise = _quadratic_streams(1, E)
        got, ref = r(rand, noise, 0.1), runner(grad)(rand, noise, 0.1)
        assert torch.equal(got[0], ref[0])
        _same_state(got[1], ref[1])
        assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])
        assert got[2]["emit"].shape == (E,)


def test_a_rule_that_replaces_its_cache_raises():
    """The tick keeps the cache object it started from: a rule whose step
    hands back a new FlatCache (its writes lost to the next tick) raises."""
    class Replacing(tagg.ACEIncremental):
        def step(self, state, arrival):
            new, u, emit, lr_scale = super().step(state, arrival)
            cache = new["cache"]
            return ({**new, "cache": FlatCache(cache.data.clone(),
                                               cache.scale.clone())},
                    u, emit, lr_scale)
    grad, rand, noise = _quadratic_streams(1, 4)
    r = make_staleness_runner(grad_fn=grad, params0=torch.ones(D),
                              aggregator=Replacing(cache_dtype="int8"),
                              n_clients=N, T=4, beta=2.0, device="cpu")
    with pytest.raises(RuntimeError, match="new cache for 'cache'"):
        r(rand, noise, 0.1)


def test_graph_true_on_the_cpu_raises():
    grad, _, _ = _quadratic_streams(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        make_staleness_runner(grad_fn=grad, params0=torch.ones(D),
                              aggregator=tagg.ACEIncremental(), n_clients=N,
                              T=4, beta=2.0, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        make_chunked_staleness_runner(
            grad_fn=grad, params0=torch.ones(D),
            aggregator=tagg.ACEIncremental(), n_clients=N, T=4, beta=2.0,
            device="cpu", capacity=4, graph=True)


# --- differential gaps: K = 16 on 20 clients, a callable server_lr --------

N20 = 20


def quadratic20(seed=1, zeta=3.0, sigma=0.3):
    """The quadratic testbed on 20 clients, in both packages."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(N20, D))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    C = (dirs * zeta).astype(np.float32)
    Cj, Ct = jnp.asarray(C), torch.as_tensor(C)

    def jax_grad(params, client, key):
        return 0.0, params - Cj[client] + sigma * jax.random.normal(key, (D,))

    def torch_grad(w, clients, noise):
        return torch.zeros(w.shape[0]), w - Ct[clients] + sigma * noise
    return (jax_grad, ttasks.ClientGrad(torch_grad, (D,), "normal"),
            lambda key: jax.random.normal(key, (D,)))


def _matches_jax(j_agg, t_agg, K, server_lr, t_server_lr, windows=None,
                 T=14, local_steps=1, speed_skew=0.0):
    beta, seed = 2.0, 7
    jax_grad, torch_grad, noise_of = quadratic20()
    n_events = default_n_events(j_agg, T) + (N20 if windows else 0)
    kw = dict(n_clients=N20, T=T, beta=beta, tau_max=6, n_events=n_events,
              seed=seed, k_batch=K, windows=windows, record_w=True,
              local_steps=local_steps, speed_skew=speed_skew)
    jr = jax_run(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                 server_lr=server_lr, **kw)
    rand, noise = replay_streams(seed, n_events, N20, beta, K, noise_of,
                                 (D,), jagg.wants_cache_init(j_agg),
                                 windows=windows, local_steps=local_steps)
    tr = torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                   aggregator=t_agg, server_lr=t_server_lr, device="cpu",
                   randomness=rand, payload_noise=noise, **kw)
    assert np.array_equal(tr.emit, jr.emit)
    assert np.array_equal(tr.ts, jr.ts)
    assert tr.total_comms == jr.total_comms
    assert np.max(np.abs(tr.ws - np.asarray(jr.ws))) <= 1e-5
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)
    return tr


# every client leaves at t = 5; half come back at t = 8, the rest at 10
WINDOWS20 = (np.full(N20, 5, np.int32),
             np.where(np.arange(N20) < N20 // 2, 8, 10).astype(np.int32))


@pytest.mark.parametrize("name,dtype", [("ace", "int8"), ("aced", "int8"),
                                        ("ca2fl", "float32")])
def test_k16_on_20_clients_matches_jax(name, dtype):
    """K = 16 arrivals a tick on 20 clients (top-16 of the Gumbel scores,
    cohorts of 16 in ACED's owner-ring) with a freeze and thaw: the model
    after every tick within 1e-5 of the JAX package's."""
    tr = _matches_jax(_make(name, dtype, 16, "jax"),
                      _make(name, dtype, 16, "torch"), 16, 0.1, 0.1,
                      windows=WINDOWS20)
    assert np.any(np.diff(tr.ts) > 1)


@pytest.mark.parametrize("name,K", [("ace", 1), ("aced", 4),
                                    ("ca2fl", 1)])
def test_callable_server_lr_matches_jax(name, K):
    """An iteration schedule η(t) = 0.2 / (1 + 0.1·t), baked into both
    runners, the init's u⁰ included: within 1e-5 of the JAX package."""
    _matches_jax(_make(name, "int8", K, "jax"),
                 _make(name, "int8", K, "torch"), K,
                 lambda t: 0.2 / (1.0 + 0.1 * t),
                 lambda t: 0.2 / (1.0 + 0.1 * t))


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "int8", 4),
                                          ("ca2fl", "float32", 1)])
def test_local_steps_match_jax(name, dtype, K):
    """Three local steps a payload (the displacement (w₀ − w₃)/(3·lr_loc)),
    each on its own noise draw of JAX's key chain, per lane at K > 1: the
    model after every tick within 1e-5 of the JAX package's."""
    _matches_jax(_make(name, dtype, K, "jax"), _make(name, dtype, K, "torch"),
                 K, 0.1, 0.1, local_steps=3)


@pytest.mark.parametrize("name,dtype,K,skew", [("ace", "int8", 1, 1.0),
                                               ("aced", "int8", 4, 1.0),
                                               ("ace", "bfloat16", 4, 0.5)])
def test_speed_skew_matches_jax(name, dtype, K, skew):
    """Log-spaced participation weights in [1/(1+skew), 1+skew] folded into
    the sampling logits, with a freeze and thaw: within 1e-5 of the JAX
    package after every tick."""
    _matches_jax(_make(name, dtype, K, "jax"), _make(name, dtype, K, "torch"),
                 K, 0.1, 0.1, windows=WINDOWS20, speed_skew=skew)


@pytest.mark.parametrize("name,K", [("ca2fl", 1), ("aced", 1), ("ace", 4)])
def test_bf16_cache_matches_jax(name, K):
    """A bf16 gradient cache (rows rounded to bf16 on write, read back in
    f32): within 1e-5 of the JAX package after every tick."""
    _matches_jax(_make(name, "bfloat16", K, "jax"),
                 _make(name, "bfloat16", K, "torch"), K, 0.1, 0.1,
                 windows=WINDOWS20)
