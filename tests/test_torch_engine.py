"""The port's staleness engine against the JAX package's, run on the same
data, the same initial model and the same random streams: the gumbels and
Exp(β) staleness of `repro.core.scan_staleness.build_staleness_randomness`,
and the payload noise that JAX's key chain hands to each client call
(replayed here: one split per call for the init batch and K = 1 ticks,
``split(key, K+1)`` then one split per lane for K > 1 ticks).

  * Quadratic testbed (paper Fig. 2): every rule of the zoo — ACE, ACED,
    CA²FL × K ∈ {1, 4} × {f32, int8}; ASGD, delay-adaptive ASGD and FedBuff
    at K ∈ {1, 4}; the direct ACE/ACED/CA²FL rules × {f32, int8} at K = 1 —
    with an availability window that freezes the run and thaws it. Final
    model, trajectory and update norms agree within 1e-5, the repo's
    contract between its engines. Inside the port, each incremental rule
    follows its direct reference within 1e-5.
  * The slice: the vision task (MLP) at reduced widths, models carried
    across with `repro_torch.convert`.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AFLConfig  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import build_staleness_randomness  # noqa: E402
from repro.core.scan_staleness import run_staleness_scan as jax_run  # noqa: E402
from repro.core.staleness_sim import NEVER  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.scan_staleness import (PayloadNoise,  # noqa: E402
                                             StalenessRandomness)
from repro_torch.core.scan_staleness import run_staleness_scan as torch_run  # noqa: E402


_SPLIT = jax.jit(jax.random.split, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _draw(noise_of):
    """`noise_of` over a batch of keys, compiled once per function."""
    return jax.jit(jax.vmap(noise_of))


def replay_streams(seed, n_events, n, beta, k_batch, noise_of, noise_shape,
                   wants_init, windows=None, local_steps=1):
    """The JAX engine's random streams for a run with `seed`, as the port's
    `StalenessRandomness` and `PayloadNoise`. Each payload call splits its
    key once and, with ``local_steps > 1``, drops that draw and splits once
    more per local step (`repro.core.scan_engine._payload_chain`)."""
    r = build_staleness_randomness(seed, n_events, n, beta, windows=windows,
                                   k_batch=k_batch)
    rand = StalenessRandomness(*(torch.as_tensor(np.array(x)) for x in
                                 (r.gumbels, r.tau_raw, r.leave_at,
                                  r.rejoin_at)))
    L = local_steps
    split, draw = _SPLIT, _draw(noise_of)

    def call(key):
        """One payload call's chain -> (key after it, (L, 2) step keys)."""
        key, sub = split(key, 2)
        if L == 1:
            return key, sub[None]
        steps = []
        for _ in range(L):
            key, sub = split(key, 2)
            steps.append(sub)
        return key, jnp.stack(steps)

    key = jax.random.PRNGKey(seed)
    init = np.zeros((n, L) + noise_shape, np.float32)
    if wants_init:
        subs = []
        for _ in range(n):
            key, steps = call(key)
            subs.append(steps)
        init[:] = np.asarray(draw(jnp.concatenate(subs))).reshape(
            (n, L) + noise_shape)
    subs = []
    for _ in range(n_events):
        if k_batch == 1:
            key, steps = call(key)
            subs.append(steps[None])
        else:
            keys = split(key, k_batch + 1)
            key = keys[0]
            subs.append(jnp.stack([call(k)[1] for k in keys[1:]]))
    subs = jnp.stack(subs)                        # (E, K, L, 2)
    ticks = np.array(draw(subs.reshape(-1, subs.shape[-1])))
    ticks = ticks.reshape((n_events, k_batch, L) + noise_shape)
    return rand, PayloadNoise(torch.as_tensor(init), torch.as_tensor(ticks))


# --- quadratic testbed -------------------------------------------------------

N, D, SIGMA = 6, 12, 0.3


def quadratic(seed=0, zeta=3.0):
    """benchmarks/fig2_heterogeneity.py's quadratic task, in both packages:
    g = w − C[client] + σ·ξ with ξ ~ N(0, I) from the payload's key."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(N, D))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    C = (dirs * zeta).astype(np.float32)
    Cj, Ct = jnp.asarray(C), torch.as_tensor(C)

    def jax_grad(params, client, key):
        return 0.0, params - Cj[client] + SIGMA * jax.random.normal(key, (D,))

    def torch_grad(w, clients, noise):
        return torch.zeros(w.shape[0]), w - Ct[clients] + SIGMA * noise
    return (jax_grad, ttasks.ClientGrad(torch_grad, (D,), "normal"),
            lambda key: jax.random.normal(key, (D,)))


def _make(name, dtype, K, lib):
    mod = tagg if lib == "torch" else jagg
    if name == "ace":
        return mod.ACEIncremental(cache_dtype=dtype)
    if name == "aced":
        return mod.ACED(tau_algo=4, cache_dtype=dtype, max_cohort=K)
    return mod.CA2FL(buffer_size=2, cache_dtype=dtype)


# every client leaves at t = 6; two come back at t = 10, the rest at t = 13:
# the run freezes at t = 6 and thaws with a jump to t = 10
WINDOWS = (np.full(N, 6, np.int32),
           np.array([10, 10, 13, 13, 13, 13], np.int32))


def _make_zoo(name, dtype, K, lib):
    """Any rule of the zoo through its package's `make_aggregator`
    (delay-adaptive τ_C = 0.4 · 5 = 2, below most of the run's delays)."""
    cfg = AFLConfig(algorithm=name, n_clients=N, cache_dtype=dtype,
                    tau_algo=4, buffer_size=2, k_batch=K,
                    max_delay_scale=0.4, delay_beta=5.0)
    return (tagg if lib == "torch" else jagg).make_aggregator(cfg)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_quadratic_trajectory_matches_jax(name, dtype, K):
    _quadratic_run_matches_jax(_make(name, dtype, K, "jax"),
                               _make(name, dtype, K, "torch"), K)


ZOO_CASES = ([(r, "float32", K) for r in ("asgd", "delay_asgd", "fedbuff")
              for K in (1, 4)]
             + [(r, dt, 1) for r in ("ace_direct", "aced_direct",
                                     "ca2fl_direct")
                for dt in ("float32", "int8")])


@pytest.mark.parametrize("name,dtype,K", ZOO_CASES)
def test_quadratic_trajectory_of_the_zoo_matches_jax(name, dtype, K):
    """The rest of the rule zoo on the same testbed, freeze and thaw
    included."""
    _quadratic_run_matches_jax(_make_zoo(name, dtype, K, "jax"),
                               _make_zoo(name, dtype, K, "torch"), K)


def _quadratic_run_matches_jax(j_agg, t_agg, K):
    T, beta, seed, lr = 18, 2.0, 3, 0.1
    jax_grad, torch_grad, noise_of = quadratic()
    n_events = default_n_events(j_agg, T) + N      # + the windows' slack
    kw = dict(n_clients=N, server_lr=lr, T=T, beta=beta, tau_max=6,
              n_events=n_events, seed=seed, k_batch=K, windows=WINDOWS,
              record_w=True)
    jr = jax_run(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                 **kw)
    rand, noise = replay_streams(seed, n_events, N, beta, K, noise_of, (D,),
                                 jagg.wants_cache_init(j_agg),
                                 windows=WINDOWS)
    tr = torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                   aggregator=t_agg, device="cpu", randomness=rand,
                   payload_noise=noise, **kw)
    # the window froze the run and the thaw jumped t
    assert np.any(np.diff(jr.ts) > 1)
    assert np.array_equal(tr.emit, jr.emit)
    assert np.array_equal(tr.ts, jr.ts)
    assert tr.total_comms == jr.total_comms
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    # the whole trajectory, event by event, not only its end
    assert np.max(np.abs(tr.ws - np.asarray(jr.ws))) <= 1e-5
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("inc,direct", [("ace", "ace_direct"),
                                        ("aced", "aced_direct"),
                                        ("ca2fl", "ca2fl_direct")])
def test_incremental_rule_follows_its_direct_reference(inc, direct, dtype):
    """Inside the port, on one stream with a freeze and thaw: each O(d)
    incremental rule and its literal O(n·d) reference emit at the same
    ticks and end within 1e-5 (the port's counterpart of
    tests/test_scan_staleness.py's incremental-vs-direct suite)."""
    _, torch_grad, _ = quadratic()
    runs = []
    for name in (inc, direct):
        runs.append(torch_run(
            grad_fn=torch_grad, params0=torch.ones(D),
            aggregator=_make_zoo(name, dtype, 1, "torch"), n_clients=N,
            server_lr=0.1, T=18, beta=2.0, tau_max=6, windows=WINDOWS,
            seed=4, record_w=True, device="cpu"))
    a, b = runs
    assert np.any(np.diff(a.ts) > 1)
    assert np.array_equal(a.emit, b.emit) and np.array_equal(a.ts, b.ts)
    assert np.max(np.abs(a.ws - b.ws)) <= 1e-5
    np.testing.assert_allclose(a.update_norms, b.update_norms, rtol=1e-5,
                               atol=1e-5)


def test_direct_rule_refuses_k_batch():
    """A direct rule has no K-arrival form: the engine raises, as the JAX
    package's does."""
    _, torch_grad, _ = quadratic()
    with pytest.raises(NotImplementedError):
        torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                  aggregator=_make_zoo("aced_direct", "int8", 4, "torch"),
                  n_clients=N, server_lr=0.1, T=6, beta=2.0, k_batch=4,
                  device="cpu")


# --- the slice: the vision task ---------------------------------------------

VISION = dict(n_clients=8, alpha=0.3, batch=6, n_classes=10, dim=8,
              hidden=(16, 8), n_train=400, n_test=100, seed=0)


def jax_vision_grad(task_kw):
    """`repro.core.fl_tasks.make_vision_task`'s gradient, built from the
    JAX package's own pieces, sampling its minibatch as
    ``ix = min(floor(uniform(key) · n_client), n_client − 1)`` — the port's
    rule — so both packages see the same minibatch."""
    kw = dict(task_kw)
    x, y = jtasks.make_classification(kw["n_train"] + kw["n_test"],
                                      kw["n_classes"], kw["dim"], noise=0.6,
                                      seed=kw["seed"])
    xtr, ytr = x[:kw["n_train"]], y[:kw["n_train"]]
    parts = jtasks.dirichlet_partition(ytr, kw["n_clients"], kw["alpha"],
                                       seed=kw["seed"] + 1)
    _, apply = jtasks.mlp_classifier((kw["dim"],) + kw["hidden"]
                                     + (kw["n_classes"],))
    cx, cy, cn = (jnp.asarray(a)
                  for a in jtasks._pad_clients(xtr, ytr, parts))
    batch = kw["batch"]

    def grad_fn(params, client, key):
        n_c = cn[client]
        u = jax.random.uniform(key, (batch,))
        ix = jnp.minimum(jnp.floor(u * n_c).astype(jnp.int32), n_c - 1)
        xb, yb = cx[client][ix], cy[client][ix]
        return jax.value_and_grad(
            lambda p: jtasks._xent(apply(p, xb), yb))(params)
    return grad_fn, lambda key: jax.random.uniform(key, (batch,))


@pytest.mark.parametrize("name,dtype,K", [("ace", "float32", 1),
                                          ("aced", "float32", 4),
                                          ("ca2fl", "float32", 4),
                                          ("ace", "int8", 4),
                                          ("ca2fl", "int8", 1)])
def test_vision_slice_matches_jax(name, dtype, K):
    """The slice end to end at reduced widths (d = 370): final model and
    per-update losses within 1e-5. The MLP gradients of the two packages
    differ only by the order of their f32 matmul sums (~1e-7 relative);
    with an int8 cache such a difference could flip one int8 code at a
    rounding boundary, which would show here as a deviation of one
    quantization step (max|g|/127 · lr/n), not as a drift."""
    T, beta, seed, lr = 16, 2.0, 1, 0.2
    jtask = jtasks.make_vision_task(**VISION)
    ttask = ttasks.make_vision_task(**VISION, device="cpu")
    jgrad, noise_of = jax_vision_grad(VISION)
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    j_agg, t_agg = _make(name, dtype, K, "jax"), _make(name, dtype, K, "torch")
    n_events = default_n_events(j_agg, T)
    kw = dict(n_clients=VISION["n_clients"], server_lr=lr, T=T, beta=beta,
              n_events=n_events, seed=seed, k_batch=K)
    jr = jax_run(grad_fn=jgrad, params0=jtask.params0, aggregator=j_agg, **kw)
    rand, noise = replay_streams(seed, n_events, VISION["n_clients"], beta,
                                 K, noise_of, (VISION["batch"],),
                                 jagg.wants_cache_init(j_agg))
    tr = torch_run(grad_fn=ttask.grad_fn, params0=params0, aggregator=t_agg,
                   device="cpu", randomness=rand, payload_noise=noise, **kw)
    assert tr.w.shape == (370,) and np.isfinite(tr.w).all()
    assert np.array_equal(tr.emit, jr.emit)
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-5)
    # the port's data, split and eval are the JAX package's
    acc_t = ttask.eval_fn(convert.unravel(torch.as_tensor(tr.w), params0))
    acc_j = jtask.eval_fn(jax.flatten_util.ravel_pytree(jtask.params0)[1](
        jnp.asarray(tr.w)))
    assert acc_t["accuracy"] == pytest.approx(acc_j["accuracy"], abs=1e-6)


def test_convert_ravel_order_matches_jax():
    jtask = jtasks.make_vision_task(**VISION)
    flat_j, _ = jax.flatten_util.ravel_pytree(jtask.params0)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jtask.params0))
    flat_t = convert.ravel(params)
    assert np.array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = convert.unravel(flat_t, params)
    assert all(torch.equal(a, b) for a, b in
               zip(convert.leaves(back), convert.leaves(params)))


def test_datasets_are_the_jax_packages():
    from repro.data import partition as jp
    from repro.data import synthetic as js
    from repro_torch.data import partition as tp
    from repro_torch.data import synthetic as ts
    xj, yj = js.make_classification(300, 10, 8, seed=4)
    xt, yt = ts.make_classification(300, 10, 8, seed=4)
    assert np.array_equal(xj, xt) and np.array_equal(yj, yt)
    for a, b in zip(jp.dirichlet_partition(yj, 7, 0.3, seed=5),
                    tp.dirichlet_partition(yt, 7, 0.3, seed=5)):
        assert np.array_equal(a, b)


def test_port_draws_its_own_streams_on_the_device():
    """Without replayed streams the engine draws gumbels, staleness and
    payload noise from a generator seeded with `seed`: the same seed gives
    the same run, another seed another one."""
    _, torch_grad, _ = quadratic()
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
              server_lr=0.1, T=8, beta=2.0, device="cpu")
    a = torch_run(aggregator=tagg.ACEIncremental(), seed=1, **kw)
    b = torch_run(aggregator=tagg.ACEIncremental(), seed=1, **kw)
    c = torch_run(aggregator=tagg.ACEIncremental(), seed=2, **kw)
    assert np.array_equal(a.w, b.w) and not np.array_equal(a.w, c.w)
    assert len(a.ts) == 7


def test_dropout_draw_and_permanent_dropout():
    """``dropout_frac``/``dropout_at`` draw that share of the clients from
    the generator's stream to leave for good at the trigger, and the run
    still reaches T on the clients that stay."""
    from repro_torch.core.scan_staleness import build_staleness_randomness
    r = build_staleness_randomness(5, 40, N, 2.0, dropout_frac=0.5,
                                   dropout_at=4, device="cpu")
    gone = (r.leave_at == 4).numpy()
    assert gone.sum() == N // 2 and (r.rejoin_at.numpy() == NEVER).all()
    _, torch_grad, _ = quadratic()
    res = torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                    aggregator=tagg.ACED(tau_algo=3), n_clients=N,
                    server_lr=0.1, T=12, beta=2.0, randomness=r,
                    device="cpu")
    assert len(res.ts) == 11 and np.isfinite(res.w).all()
