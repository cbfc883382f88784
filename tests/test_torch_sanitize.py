"""The port's sanitize checks (`repro_torch.core.sanitize`, the engines'
``checkify_invariants``) against the JAX package's checkify sanitizers
(`tests/test_checkify.py`'s cases) on the same inputs: the JAX streams
replayed into the port. Off by default and bit-identical to off on clean
runs; on, a run raises `RuntimeError` with JAX's message where JAX's
checkify raises. Also the repair of ACED's owner-ring read: a corrupted
slot no longer faults the step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import delays as jdelays  # noqa: E402
from repro.core import sanitize as jsanitize  # noqa: E402
from repro.core import scan_engine as jscan  # noqa: E402
from repro.core import scan_staleness as jstal  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import sanitize  # noqa: E402
from repro_torch.core.aggregators import Arrival, ArrivalBatch  # noqa: E402
from repro_torch.core.fl_tasks import ClientGrad  # noqa: E402
from repro_torch.core.scan_engine import (make_scan_runner,  # noqa: E402
                                          run_scan_seeds, sweep)
from repro_torch.core.scan_staleness import (  # noqa: E402
    make_chunked_staleness_runner, make_staleness_runner, run_staleness_grid,
    run_staleness_scan, run_staleness_seeds)
from test_torch_engine import replay_streams  # noqa: E402
from test_torch_runner import _same_state  # noqa: E402

N, D, T, TAU, N_EV = 4, 16, 48, 8, 64
HALF = N_EV // 2


def _jax_grad(params, client, rng):
    loss = 0.5 * jnp.sum(params ** 2)
    return loss, params + 0.01 * jax.random.normal(rng, params.shape)


TORCH_GRAD = ClientGrad(lambda w, c, noise: (0.5 * (w ** 2).sum(-1),
                                             w + 0.01 * noise), (D,),
                        "normal")
W0 = np.linspace(-1.0, 1.0, D).astype(np.float32)


def _kwargs(lib, K=1, **over):
    mod = jagg if lib == "jax" else tagg
    agg = (mod.ACED(tau_algo=TAU) if K == 1
           else mod.ACED(tau_algo=TAU, max_cohort=K))
    kw = dict(grad_fn=_jax_grad if lib == "jax" else TORCH_GRAD,
              params0=jnp.asarray(W0) if lib == "jax" else torch.tensor(W0),
              aggregator=agg, n_clients=N, T=T, beta=5.0,
              server_lr=(lambda t: 0.1), tau_max=TAU, resync_every=8,
              k_batch=K)
    if lib == "torch":
        kw["device"] = "cpu"
    kw.update(over)
    return kw


def _streams(K=1):
    """JAX's randomness and payload noise for seed 0, as the port's."""
    return replay_streams(0, N_EV, N, 5.0, K,
                          lambda key: jax.random.normal(key, (D,)), (D,),
                          True)


@pytest.fixture(scope="module")
def streams():
    return _streams()


def test_env_flag_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    assert sanitize.enabled() is False
    for val in ("1", "true", "on", "yes"):
        monkeypatch.setenv("REPRO_CHECKIFY", val)
        assert sanitize.enabled() is True
    for val in ("0", "false", "off", ""):
        monkeypatch.setenv("REPRO_CHECKIFY", val)
        assert sanitize.enabled() is False
    # an explicit argument beats the environment either way
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    assert sanitize.enabled(False) is False
    monkeypatch.setenv("REPRO_CHECKIFY", "0")
    assert sanitize.enabled(True) is True


@pytest.mark.parametrize("env", [None, "1"])
def test_default_follows_the_environment(monkeypatch, env):
    """Off unless ``REPRO_CHECKIFY`` says on; off builds no record."""
    if env is None:
        monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    else:
        monkeypatch.setenv("REPRO_CHECKIFY", env)
    on = env is not None
    run = make_staleness_runner(**_kwargs("torch"))
    assert run.prog.checks is on
    assert ("checks" in run.prog.init(0.0, torch.zeros(N, 1, D))) is on
    chunked = make_chunked_staleness_runner(capacity=8, **_kwargs("torch"))
    assert chunked.checkify_invariants is on
    scan = make_scan_runner(grad_fn=TORCH_GRAD, params0=torch.tensor(W0),
                            aggregator=tagg.ACED(tau_algo=TAU), n_clients=N,
                            server_lr=0.1, T=T, device="cpu")
    assert scan.prog.checks is on


@pytest.mark.parametrize("K", [1, 4])
def test_staleness_clean_run_bit_identical(K):
    """A healthy trajectory passes every check and matches the unchecked
    runner bit for bit (at K = 4 the batch and commit checks too)."""
    rand, noise = _streams(K)
    runs = [make_staleness_runner(**_kwargs("torch", K),
                                  checkify_invariants=on)(rand, noise)
            for on in (False, True)]
    (w1, s1, o1, _), (w2, s2, o2, _) = runs
    assert torch.equal(w1, w2)
    _same_state(s1, s2)
    assert all(torch.equal(o1[k], o2[k]) for k in o1)
    assert bool(torch.isfinite(w2).all())


def _schedule():
    return jdelays.build_schedule(
        jdelays.ExponentialDelays(beta=5.0, kappa=0.0, n_clients=N, seed=0),
        N_EV, None, 0)


def test_scan_engine_clean_run_bit_identical(streams):
    _, noise = streams
    sched = _schedule()
    kw = dict(grad_fn=TORCH_GRAD, params0=torch.tensor(W0),
              aggregator=tagg.ACED(tau_algo=TAU), n_clients=N,
              server_lr=0.1, T=T, device="cpu")
    w1, s1, o1 = make_scan_runner(**kw, checkify_invariants=False)(
        sched.arrive, sched.dispatch, noise)
    w2, s2, o2 = make_scan_runner(**kw, checkify_invariants=True)(
        sched.arrive, sched.dispatch, noise)
    assert torch.equal(w1, w2)
    _same_state(s1, s2)
    assert all(torch.equal(o1[k], o2[k]) for k in o1)


@pytest.fixture(scope="module")
def chunked(streams):
    """Both packages' checked chunked runners after the first half of the
    same run."""
    rand, noise = streams
    jr = jstal.build_staleness_randomness(0, N_EV, N, 5.0)
    jcr = jstal.make_chunked_staleness_runner(**_kwargs("jax"),
                                              checkify_invariants=True)
    jcarry, _ = jcr.chunk(jcr.init(jax.random.PRNGKey(0), jnp.float32(0.0)),
                          jr.gumbels[:HALF], jr.tau_raw[:HALF], jr.leave_at,
                          jr.rejoin_at, jnp.float32(0.0))
    tcr = make_chunked_staleness_runner(capacity=HALF, **_kwargs("torch"),
                                        checkify_invariants=True)
    tcarry, _ = tcr.chunk(tcr.init(0.0, noise.init), rand.slice(0, HALF),
                          noise.ticks[:HALF])
    return (jcr, jcarry, jr), (tcr, tcarry)


def _jax_second_half(jcr, carry, jr):
    c, _ = jcr.chunk(carry, jr.gumbels[HALF:], jr.tau_raw[HALF:],
                     jr.leave_at, jr.rejoin_at, jnp.float32(0.0))
    return jax.block_until_ready(c["w"])


def _torch_second_half(tcr, carry, streams):
    rand, noise = streams
    return tcr.chunk(carry, rand.slice(HALF, N_EV), noise.ticks[HALF:])[0]


def test_chunked_clean_chunk_passes(chunked, streams):
    (jcr, jcarry, jr), (tcr, tcarry) = chunked
    assert tcr.checkify_invariants
    w = _torch_second_half(tcr, tcarry, streams)["w"]
    assert bool(torch.isfinite(w).all())
    # the port followed JAX's trajectory
    assert np.max(np.abs(w.numpy() - np.asarray(
        _jax_second_half(jcr, jcarry, jr)))) <= 1e-5


def _corrupt(carry, path, fn):
    """A copy of `carry` with carry[path...] replaced by fn(value)."""
    bad = dict(carry)
    if len(path) == 2:
        bad[path[0]] = dict(carry[path[0]])
        bad[path[0]][path[1]] = fn(carry[path[0]][path[1]])
    else:
        bad[path[0]] = fn(carry[path[0]])
    return bad


TRIPS = {
    "non-finite server model": (
        ("w",), lambda x: x.at[0].set(jnp.nan),
        lambda x: x.clone().index_fill_(0, torch.tensor([0]), float("nan"))),
    "owner-ring slot out of bounds": (
        ("state", "ring"), lambda x: x.at[0].set(9999),
        lambda x: x.clone().index_fill_(0, torch.tensor([0]), 9999)),
    "incremental sums diverged from resync recompute": (
        ("state", "asum"), lambda x: x + 1.0, lambda x: x + 1.0),
}


@pytest.mark.parametrize("message", sorted(TRIPS))
def test_corrupted_carry_trips_like_jax(chunked, streams, message):
    """A NaN server model, an owner-ring slot of 9999 (which faulted the
    port's ring read before its repair) and running sums off by one each
    raise in both packages with the same message; the port names the
    chunk's event, counted from the run's start."""
    (jcr, jcarry, jr), (tcr, tcarry) = chunked
    path, jfn, tfn = TRIPS[message]
    with pytest.raises(Exception, match=message):
        _jax_second_half(jcr, _corrupt(jcarry, path, jfn), jr)
    with pytest.raises(RuntimeError, match=message + r" at event (\d+)") as e:
        _torch_second_half(tcr, _corrupt(tcarry, path, tfn),
                           streams)
    event = int(e.value.args[0].rsplit(" ", 1)[1])
    assert HALF <= event < N_EV


def test_chunked_off_matches_on_bit_identical(chunked, streams):
    _, (tcr_on, _) = chunked
    rand, noise = streams
    tcr_off = make_chunked_staleness_runner(capacity=HALF, **_kwargs("torch"),
                                            checkify_invariants=False)
    outs = []
    for cr in (tcr_off, tcr_on):
        c, o = cr.chunk(cr.init(0.0, noise.init), rand.slice(0, HALF),
                        noise.ticks[:HALF])
        outs.append((c, o))
    (c1, o1), (c2, o2) = outs
    assert "checks" not in c1 and set(c2) - set(c1) == {"checks"}
    assert all(int(v) == -1 for v in c2["checks"].values())
    assert torch.equal(c1["w"], c2["w"])
    _same_state(c1["state"], c2["state"])
    assert all(torch.equal(o1[k], o2[k]) for k in o1)


BATCHES = [([0, 1, 2], [0, TAU, 1], [True] * 3, None),
           ([0, N, 2], [0, 0, 0], [True] * 3, "client index out of range"),
           ([0, 1, 1], [0, 0, 0], [True] * 3, "duplicate client"),
           ([0, 1, 2], [0, TAU + 1, 0], [True] * 3, "staleness out of range"),
           # an invalid lane is exempt from every invariant
           ([0, N, 0], [0, TAU + 5, 0], [True, False, False], None)]


@pytest.mark.parametrize("js,taus,valid,message", BATCHES)
def test_batch_arrival_invariants_trip_like_jax(js, taus, valid, message):
    checks = sanitize.check_batch_arrivals(
        torch.tensor(js), torch.tensor(taus), torch.tensor(valid), N, TAU)
    failed = [m for m, ok in checks if not bool(ok)]
    checked = jsanitize.wrap_checked(
        lambda j, t, v: jsanitize.check_batch_arrivals(
            j, t, v, n_clients=N, tau_max=TAU) or jnp.zeros(()))
    args = (jnp.asarray(js, jnp.int32), jnp.asarray(taus, jnp.int32),
            jnp.asarray(valid))
    if message is None:
        assert failed == []
        checked(*args)
    else:
        assert len(failed) == 1 and message in failed[0]
        with pytest.raises(Exception, match=message):
            checked(*args)


@pytest.mark.parametrize("engine", ["staleness", "event"])
def test_nan_params0_raises_like_jax(engine):
    """A run from a NaN initial model: JAX's checked runner and the port's
    both report the non-finite server model (the port at event 0)."""
    nan = np.full(D, np.nan, np.float32)
    rand, noise = _streams()
    if engine == "staleness":
        jr = jstal.build_staleness_randomness(0, N_EV, N, 5.0)
        jrun = jstal.make_staleness_runner(
            **_kwargs("jax", params0=jnp.asarray(nan)),
            checkify_invariants=True)
        with pytest.raises(Exception, match="non-finite server model"):
            jrun(jax.random.PRNGKey(0), jr.gumbels, jr.tau_raw, jr.leave_at,
                 jr.rejoin_at, jnp.float32(0.0))
        trun = make_staleness_runner(**_kwargs("torch",
                                               params0=torch.tensor(nan)),
                                     checkify_invariants=True)
        call = lambda: trun(rand, noise)
    else:
        sched = _schedule()
        kw = dict(aggregator=jagg.ACED(tau_algo=TAU), n_clients=N,
                  server_lr=0.1, T=T, n_events=N_EV)
        jrun = jscan.make_scan_runner(grad_fn=_jax_grad,
                                      params0=jnp.asarray(nan),
                                      checkify_invariants=True, **kw)
        with pytest.raises(Exception, match="non-finite server model"):
            jrun(jax.random.PRNGKey(0), sched.arrive, sched.dispatch)
        kw["aggregator"] = tagg.ACED(tau_algo=TAU)
        trun = make_scan_runner(grad_fn=TORCH_GRAD, params0=torch.tensor(nan),
                                checkify_invariants=True, device="cpu", **kw)
        call = lambda: trun(sched.arrive, sched.dispatch, noise)
    with pytest.raises(RuntimeError,
                       match="non-finite server model at event 0"):
        call()


def test_k_batch_checked_clean_run_passes():
    rand, noise = _streams(3)
    run = make_staleness_runner(**_kwargs("torch", 3),
                                checkify_invariants=True)
    w, _, _, _ = run(rand, noise)
    assert bool(torch.isfinite(w).all())
    assert set(run.carry["checks"]) >= {
        sanitize.BATCH_DUPLICATE, sanitize.COMMIT_COUNT, sanitize.RESYNC}


def test_sweeps_force_checks_off(monkeypatch):
    """With ``REPRO_CHECKIFY=1`` a single run from a NaN model raises, and
    the sweeps, which build their runners unchecked as JAX's do, return
    their (NaN) results."""
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    nan = torch.full((D,), float("nan"))
    kw = dict(grad_fn=TORCH_GRAD, params0=nan, n_clients=N, T=T, device="cpu")
    with pytest.raises(RuntimeError, match="non-finite server model"):
        run_staleness_scan(aggregator=tagg.ACED(tau_algo=TAU), server_lr=0.1,
                           **kw)
    res = run_staleness_seeds(aggregator=tagg.ACED(tau_algo=TAU),
                              server_lr=0.1, seeds=(0, 1), **kw)
    grid = run_staleness_grid(aggregator=tagg.ACED(tau_algo=TAU),
                              lrs=(0.1, 0.2), seeds=(0,), **kw)
    scans = run_scan_seeds(aggregator=tagg.ACED(tau_algo=TAU), server_lr=0.1,
                           seeds=(0, 1), **kw)
    rows = sweep(server_lr=0.1, seeds=(0,), algorithms=("ace", "aced"), **kw)
    for r in res + scans + [g[0] for g in grid] + [
            row["results"][0] for row in rows.values()]:
        assert np.isnan(r.w).all()


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_corrupted_ring_slot_does_not_fault(K, dtype):
    """ACED's expiry reads the owner-ring slot it visits and gathers that
    owner's t_start and cache row: a slot holding 9999 (≥ n) raised
    IndexError here (a device assert on the card). The gather now clamps
    the owner into [0, n−1], so the step runs; the values it computes from
    a corrupted slot are no contract (the sanitize ring check reports the
    slot)."""
    n, d, P = 5, 8, TAU + 2
    agg = tagg.ACED(tau_algo=TAU, cache_dtype=dtype, max_cohort=K)
    g = torch.Generator().manual_seed(0)
    state = agg.init_state(n, d, torch.randn(n, d, generator=g), "cpu")
    state["ring"][0] = 9999          # slot 0: visited first at t = τ + 1
    t = torch.tensor(TAU + 1, dtype=torch.int32)
    if K == 1:
        new, u, emit, _ = agg.step(state, Arrival(
            torch.tensor([2]), torch.randn(d, generator=g), t,
            torch.tensor(0)))
    else:
        new, u, emit, _ = agg.step_batch(state, ArrivalBatch(
            torch.tensor([2, 0, 4, 1]), torch.randn(4, d, generator=g), t,
            torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool)))
    assert u.shape == (d,) and new["ring"].shape[0] == P
