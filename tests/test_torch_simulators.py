"""The port's host references (`repro_torch.core.AFLSimulator`,
`StalenessSimulator`) against the port's engines, on the quadratic testbed
at small n, d and T — the north star's trajectory gate inside the port —
and the protocol invariants of `tests/test_simulators.py`.

  * `StalenessSimulator` in replay mode against `run_staleness_scan` on the
    same `StalenessRandomness` and payload noise (drawn by both from the
    seed): asgd, fedbuff, ca2fl, ace and aced × K ∈ {1, 4, 16}, f32 and
    int8 caches, with and without faults, clip and resync; dropout,
    windows that freeze and thaw the run, speed skew, both τ caps, the eval
    cadence, a callable server lr and local steps.
  * `AFLSimulator` against `run_scan` on `build_schedule`'s schedule, the
    five rules × concurrency {n, 5}.

Tolerances: the final model within 1e-5 (the repo's contract between its
engines), losses and update norms within rtol 1e-4, `ts`, client uploads,
eval marks and guard counters identical. At K > 1 both packages' engines
count one upload per tick and their host simulators one per live lane, so
the host's count is held against the engine's live lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ACED, CA2FL, ACEDirect,  # noqa: E402
                              ACEIncremental, AFLSimulator, ExponentialDelays,
                              FedBuff, FlatCache, StalenessSimulator,
                              VanillaASGD, build_schedule, run_scan)
from repro_torch.core.aggregators import ArrivalBatch  # noqa: E402
from repro_torch.core.fl_tasks import ClientGrad  # noqa: E402
from repro_torch.core.scan_engine import default_n_events  # noqa: E402
from repro_torch.core.scan_staleness import (  # noqa: E402
    _staleness_result, build_fault_schedule, build_payload_noise,
    build_staleness_randomness, eval_marks_for, make_staleness_runner)
from repro_torch.core.staleness_sim import NEVER  # noqa: E402

N, D, BETA, LR, SEED = 8, 6, 2.0, 0.05, 1
RATES = dict(nan_rate=0.1, explode_rate=0.08, byzantine_rate=0.08,
             overstale_rate=0.08)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops are slow with many intra-op threads on a shared host;
    the runs here are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def quadratic(n=N, d=D, zeta=2.0, sigma=0.2, seed=0):
    """g = w − C[client] + σ·ξ, ξ ~ N(0, I), loss ½‖w − C[client]‖²;
    -> (grad_fn, w* = mean of the optima)."""
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.normal(size=(n, d)) * zeta, dtype=torch.float32)

    def grad(w, clients, noise):
        diff = w - C[clients]
        return 0.5 * (diff ** 2).sum(1), diff + sigma * noise
    return ClientGrad(grad, (d,), "normal"), C.mean(0).numpy()


def make_rule(name, dtype="float32", K=1):
    return {"asgd": lambda: VanillaASGD(),
            "fedbuff": lambda: FedBuff(buffer_size=4),
            "ca2fl": lambda: CA2FL(buffer_size=4, cache_dtype=dtype),
            "ace": lambda: ACEIncremental(cache_dtype=dtype),
            "aced": lambda: ACED(tau_algo=5, cache_dtype=dtype,
                                 max_cohort=K)}[name]()


def _dist(params):
    return {"dist": float(torch.linalg.vector_norm(params))}


def engine_uploads(outs, rand, n, K, T, n_init):
    """Client uploads of an engine run counted as the host counts them:
    the live lanes, min(K, clients available at t), of every tick before
    T that was not frozen."""
    t = outs["t"].numpy().astype(np.int64)
    proc = (t < T) & outs["alive"].numpy()
    leave = rand.leave_at.numpy().astype(np.int64)
    rejoin = rand.rejoin_at.numpy().astype(np.int64)
    avail = ((t[:, None] < leave) | (t[:, None] >= rejoin)).sum(1)
    return n_init + int(np.minimum(K, avail)[proc].sum())


def host_and_engine(name, dtype="float32", K=1, *, n=N, T=30, beta=BETA,
                    tau_max=None, speed_skew=0.0, dropout_frac=0.0,
                    dropout_at=None, rejoin_at=None, windows=None,
                    eval_every=None, faults=False, clip_norm=0.0,
                    resync_every=None, server_lr=LR, local_steps=1):
    """One host run (replay mode) and one engine run on the same streams,
    both drawing the payload noise from the seed -> (sim, host result,
    engine result, the engine's uploads counted per live lane)."""
    grad_fn, _ = quadratic(n)
    agg = make_rule(name, dtype, K)
    E = (default_n_events(agg, T) if K == 1 else T) + (
        n if rejoin_at is not None or windows is not None else 0)
    fa = None
    if faults:
        E += 40                  # quarantined and rejected events never emit
        fa = build_fault_schedule(7, E, k_batch=K, device="cpu", **RATES)
    rand = build_staleness_randomness(SEED, E, n, beta, dropout_frac,
                                      speed_skew, dropout_at=dropout_at,
                                      rejoin_at=rejoin_at, windows=windows,
                                      k_batch=K, device="cpu")
    kw = dict(grad_fn=grad_fn, params0=torch.zeros(D), n_clients=n,
              tau_max=tau_max, speed_skew=speed_skew,
              local_steps=local_steps, k_batch=K, resync_every=resync_every,
              device="cpu")
    sim = StalenessSimulator(
        aggregator=make_rule(name, dtype, K), server_lr=server_lr, beta=beta,
        eval_fn=_dist if eval_every else None, eval_every=eval_every or T,
        seed=SEED, replay=rand, faults=fa, clip_norm=clip_norm, **kw)
    hr = sim.run(T)
    marks = eval_marks_for(T, eval_every) if eval_every else None
    guards = fa is not None or clip_norm > 0
    runner = make_staleness_runner(
        aggregator=make_rule(name, dtype, K), T=T, beta=beta,
        server_lr=server_lr if callable(server_lr) else None,
        eval_marks=marks, guards=guards, **kw)
    noise = build_payload_noise(grad_fn, SEED, E, n, K, local_steps, "cpu")
    args = (rand, noise, 0.0 if callable(server_lr) else server_lr)
    run = runner(*args, fa, clip_norm) if guards else runner(*args)
    n_init = n if name in ("ace", "aced") else 0
    sr = _staleness_result(run, T, n_init, marks, _dist, torch.zeros(D))
    return sim, hr, sr, engine_uploads(run[2], rand, n, K, T, n_init)


def assert_equivalent(sim, hr, sr, uploads=None, evals=True):
    assert np.isfinite(sr.w).all()
    assert np.max(np.abs(sr.w - sim.w.numpy())) <= 1e-5
    assert sr.ts.tolist() == hr.ts
    np.testing.assert_allclose(sr.losses, hr.losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sr.update_norms, hr.update_norms, rtol=1e-4,
                               atol=1e-5)
    assert hr.total_comms == (sr.total_comms if uploads is None else uploads)
    assert sr.faults == hr.faults
    if evals:                       # the event engine has no eval cadence
        assert sr.eval_ts == hr.eval_ts
    for se, he in zip(sr.evals, hr.evals):
        np.testing.assert_allclose(se["dist"], he["dist"], rtol=1e-4)


# --- StalenessSimulator against the staleness engine ------------------------

RULE_CASES = ([(r, "float32") for r in ("asgd", "fedbuff")]
              + [(r, dt) for r in ("ca2fl", "ace", "aced")
                 for dt in ("float32", "int8")])


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("name,dtype", RULE_CASES)
def test_staleness_sim_matches_the_engine(name, dtype, K):
    """The trajectory gate: K = 16 on 20 clients (most of the pool a
    tick)."""
    n, T = (20, 12) if K == 16 else (N, 30)
    sim, hr, sr, uploads = host_and_engine(name, dtype, K, n=n, T=T)
    assert len(hr.ts) > 0
    assert_equivalent(sim, hr, sr, uploads)
    if K == 1:
        assert sr.total_comms == hr.total_comms


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("name", ["asgd", "fedbuff", "ca2fl", "ace", "aced"])
def test_faulted_staleness_sim_matches_the_engine(name, K):
    """NaN quarantine, explode/Byzantine clipping, over-stale rejection and
    resync every 5 updates, lane by lane: identical guard counters, every
    guard fired."""
    n, T = (20, 12) if K == 16 else (N, 30)
    sim, hr, sr, uploads = host_and_engine(
        name, "int8", K, n=n, T=T, tau_max=6, faults=True, clip_norm=3.0,
        resync_every=5)
    assert_equivalent(sim, hr, sr, uploads)
    assert min(hr.faults.values()) > 0, hr.faults


def _windows(n):
    leave = np.full(n, NEVER, np.int64)
    rejoin = np.full(n, NEVER, np.int64)
    leave[2], rejoin[2] = 10, 30           # mid-run absence
    leave[5], rejoin[5] = 0, 20            # late joiner
    leave[7] = 25                          # permanent dropout
    return leave, rejoin


def _freeze(n):
    # every client leaves at t = 12; all but one come back at 22
    leave, rejoin = np.full(n, 12, np.int64), np.full(n, 22, np.int64)
    rejoin[3] = 30
    return leave, rejoin


SCENARIOS = {
    "dropout": dict(n=10, T=40, dropout_frac=0.5, dropout_at=20),
    "all_dropped": dict(T=30, dropout_frac=1.0, dropout_at=12),
    "rejoin": dict(n=10, T=40, dropout_frac=0.5, dropout_at=15,
                   rejoin_at=28, eval_every=10),
    "windows": dict(n=10, T=40, windows=_windows(10)),
    "freeze_thaw": dict(T=40, windows=_freeze(N), eval_every=10),
    "speed_skew": dict(speed_skew=2.0),
    "tau_max_cap": dict(beta=50.0, tau_max=7),
    "history_cap": dict(beta=30.0, T=20),
    "eval_cadence": dict(eval_every=7),
    "callable_lr": dict(server_lr=lambda t: 0.1 / torch.sqrt(t + 1.0)),
    "local_steps": dict(local_steps=3),
}


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_staleness_sim_scenarios_match_the_engine(scenario, K):
    kw = SCENARIOS[scenario]
    sim, hr, sr, uploads = host_and_engine("aced", "int8", K, **kw)
    assert_equivalent(sim, hr, sr, uploads)
    if scenario == "freeze_thaw":
        assert not [t for t in hr.ts if 12 < t < 22]
        assert max(hr.ts) >= 22
    if scenario == "all_dropped":
        assert len(hr.ts) == 11                # init, then t = 1 .. 11
    if scenario == "eval_cadence":
        assert hr.eval_ts == [7, 14, 21, 28, 30]


def test_gone_lanes_order_does_not_change_the_state():
    """The engine's `torch.topk` orders tied -inf (gone) lanes as it likes;
    those lanes are invalid, so any order of them gives the same state and
    update, bit for bit, for every rule of the K > 1 path."""
    gen = torch.Generator().manual_seed(0)
    init = torch.randn((N, D), generator=gen)
    payloads = torch.randn((4, D), generator=gen)
    valid = torch.tensor([True, True, False, False])
    for name in ("asgd", "fedbuff", "ca2fl", "ace", "aced"):
        for dtype in ("float32", "int8"):
            out = []
            for gone in ([5, 6], [6, 5]):
                agg = make_rule(name, dtype, 4)
                state = agg.init_state(N, D, init.clone(), "cpu")
                p = payloads.clone()
                p[2:] = payloads[2:][torch.tensor(gone) - 5]
                out.append(agg.step_batch(state, ArrivalBatch(
                    torch.tensor([1, 3] + gone), p, 3,
                    torch.tensor([0, 2, 1, 1], dtype=torch.int32), valid)))
            (s1, u1, e1, _), (s2, u2, e2, _) = out
            assert torch.equal(u1, u2) and torch.equal(e1, e2), name
            for k, v in s1.items():
                if isinstance(v, FlatCache):
                    assert torch.equal(v.data, s2[k].data), (name, dtype)
                    assert torch.equal(v.scale, s2[k].scale), (name, dtype)
                else:
                    assert torch.equal(v, s2[k]), (name, dtype, k)


# --- AFLSimulator against the event engine -----------------------------------

@pytest.mark.parametrize("concurrency", [None, 5])
@pytest.mark.parametrize("name", ["asgd", "fedbuff", "ca2fl", "ace", "aced"])
def test_afl_sim_matches_the_event_engine(name, concurrency):
    """Speed-skewed delays, the int8 cache, the noise each draws from the
    seed: the arrival order is `build_schedule`'s, the run `run_scan`'s."""
    grad_fn, _ = quadratic()
    T, seed = 30, 2
    arrivals = []

    def spy(w, clients, noise):
        arrivals.extend(clients.tolist())
        return grad_fn(w, clients, noise)

    def delays():
        return ExponentialDelays(beta=2.0, kappa=2.0, n_clients=N, seed=seed)
    kw = dict(params0=torch.ones(D), n_clients=N, server_lr=0.1,
              concurrency=concurrency, seed=seed, device="cpu")
    sim = AFLSimulator(grad_fn=ClientGrad(spy, (D,), "normal"),
                       aggregator=make_rule(name, "int8"), delays=delays(),
                       eval_fn=_dist, eval_every=7, **kw)
    hr = sim.run(T)
    sr = run_scan(grad_fn=grad_fn, aggregator=make_rule(name, "int8"),
                  delays=delays(), T=T, **kw)
    assert_equivalent(sim, hr, sr, evals=False)
    assert hr.eval_ts == [7, 14, 21, 28, 30]
    n_init = N if name in ("ace", "aced") else 0
    sched = build_schedule(delays(), default_n_events(make_rule(name), T),
                           concurrency, seed)
    assert arrivals[n_init:] == sched.arrive[:len(arrivals) - n_init].tolist()


def test_afl_sim_dropout_consumes_events_and_extends_its_noise():
    """A pop of a dropped client consumes its noise row unread; the noise
    drawn from the seed grows past the rule's budget (deterministically),
    and noise a caller passed raises when it runs out."""
    grad_fn, _ = quadratic()
    kw = dict(grad_fn=grad_fn, params0=torch.zeros(D), n_clients=N,
              server_lr=0.05, dropout_frac=0.5, dropout_at=10, seed=4,
              device="cpu")

    def run(**extra):
        sim = AFLSimulator(aggregator=VanillaASGD(), delays=ExponentialDelays(
            beta=2.0, n_clients=N, seed=4), **kw, **extra)
        return sim, sim.run(40)
    (s1, r1), (s2, r2) = run(), run()
    assert len(r1.ts) == 40 and torch.equal(s1.w, s2.w)
    # the budget is T events; the dropped clients' pending pops need more
    assert r1.total_comms == 40
    short = build_payload_noise(grad_fn, 4, 40, N, device="cpu")
    with pytest.raises(ValueError, match="payload noise for 40 events"):
        run(payload_noise=short)


def test_non_replay_noise_grows_past_the_budget():
    """A non-replay run whose quarantined and rejected events push it past
    the rule's event budget reads noise rows drawn from a generator seeded
    from its seed: the run reaches T, deterministically."""
    grad_fn, _ = quadratic()
    T = 30
    faults = build_fault_schedule(3, 3 * T, nan_rate=0.2, overstale_rate=0.2,
                                  device="cpu")

    def run():
        sim = StalenessSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                                 aggregator=VanillaASGD(), n_clients=N,
                                 server_lr=LR, beta=BETA, seed=6,
                                 faults=faults, device="cpu")
        return sim, sim.run(T)
    (s1, r1), (s2, r2) = run(), run()
    assert len(r1.ts) == T and r1.total_comms > T      # past the T events
    assert r1.faults["quarantined"] + r1.faults["rejected"] > 0
    assert torch.equal(s1.w, s2.w) and r1.faults == r2.faults


# --- protocol invariants (tests/test_simulators.py) --------------------------

def test_event_sim_counts_comms():
    grad_fn, _ = quadratic()
    T = 40
    sim = AFLSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                       aggregator=ACEIncremental(), n_clients=N,
                       server_lr=0.05,
                       delays=ExponentialDelays(beta=2.0, n_clients=N),
                       seed=0, device="cpu")
    r = sim.run(T)
    assert r.total_comms == N + T - 1      # the first update is the init's
    assert len(r.losses) == T - 1
    M = 4
    sim = AFLSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                       aggregator=FedBuff(buffer_size=M), n_clients=N,
                       server_lr=0.05,
                       delays=ExponentialDelays(beta=2.0, n_clients=N),
                       seed=0, device="cpu")
    r = sim.run(10)
    assert r.total_comms == pytest.approx(M * 10, abs=M)   # Table a.1


def test_staleness_sim_respects_tau_max():
    """β ≫ τ_max: every arrival's staleness is clamped to τ_max."""
    grad_fn, _ = quadratic()
    seen = []

    class Spy(VanillaASGD):
        def on_arrival(self, state, arr):
            seen.append(arr.staleness)
            return super().on_arrival(state, arr)

    sim = StalenessSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                             aggregator=Spy(), n_clients=N, server_lr=0.05,
                             beta=50.0, tau_max=7, seed=1, device="cpu")
    r = sim.run(30)
    assert len(r.losses) == 30
    assert max(seen) == 7 and min(seen) >= 0


def test_legacy_dropout_fires_once_and_skips_an_empty_draw():
    """Non-replay dropout: cache-init consumes iteration 0 and the run
    reaches T; a k = 0 draw leaves the stream alone."""
    grad_fn, _ = quadratic(10)
    sim = StalenessSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                             aggregator=ACED(tau_algo=5), n_clients=10,
                             server_lr=0.05, beta=2.0, dropout_frac=0.5,
                             dropout_at=30, seed=2, device="cpu")
    assert len(sim.run(60).losses) == 59

    def run(**kw):
        sim = StalenessSimulator(grad_fn=grad_fn, params0=torch.zeros(D),
                                 aggregator=VanillaASGD(), n_clients=10,
                                 server_lr=0.05, beta=2.0, seed=5,
                                 device="cpu", **kw)
        sim.run(40)
        return sim.w
    assert torch.equal(run(), run(dropout_frac=0.05, dropout_at=10))


def test_host_windows_leave_and_rejoin():
    """Non-replay windows: a client inside its window never arrives; it
    participates outside it."""
    grad_fn, _ = quadratic()
    leave, rejoin = np.full(N, NEVER, np.int64), np.full(N, NEVER, np.int64)
    leave[0], rejoin[0] = 5, 30
    arrivals = []

    def spy(w, clients, noise):
        arrivals.extend(clients.tolist())
        return grad_fn(w, clients, noise)

    sim = StalenessSimulator(grad_fn=ClientGrad(spy, (D,), "normal"),
                             params0=torch.zeros(D), aggregator=VanillaASGD(),
                             n_clients=N, server_lr=0.05, beta=2.0, seed=3,
                             windows=(leave, rejoin), device="cpu")
    r = sim.run(50)
    assert len(r.losses) == 50
    assert 0 not in [j for t, j in zip(r.ts, arrivals) if 5 <= t < 30]
    assert 0 in arrivals


def test_sim_deterministic_given_seed():
    grad_fn, _ = quadratic()

    def run(sim_cls, **kw):
        sim = sim_cls(grad_fn=grad_fn, params0=torch.zeros(D),
                      aggregator=ACEDirect(), n_clients=N, server_lr=0.05,
                      seed=7, device="cpu", **kw)
        sim.run(25)
        return sim.w
    assert torch.equal(run(StalenessSimulator, beta=3.0),
                       run(StalenessSimulator, beta=3.0))
    d = dict(delays=ExponentialDelays(beta=3.0, n_clients=N, seed=7))
    w1 = run(AFLSimulator, **d)
    d = dict(delays=ExponentialDelays(beta=3.0, n_clients=N, seed=7))
    assert torch.equal(w1, run(AFLSimulator, **d))


def test_convergence_ace_beats_asgd_on_heterogeneous_quadratic():
    """The paper's central claim at steady state: all-client aggregation
    reaches a lower error floor than single-client updates."""
    n, d = 20, 10
    grad_fn, w_star = quadratic(n, d, zeta=3.0, sigma=0.3, seed=3)

    def floor(agg):
        sim = StalenessSimulator(grad_fn=grad_fn, params0=torch.zeros(d),
                                 aggregator=agg, n_clients=n, server_lr=0.05,
                                 beta=3.0, seed=4, device="cpu")
        sim.run(300)
        return float(np.sum((sim.w.numpy() - w_star) ** 2))
    assert floor(ACEIncremental()) < floor(VanillaASGD())


def test_host_k_batch_requires_replay_and_matching_faults():
    grad_fn, _ = quadratic()
    kw = dict(grad_fn=grad_fn, params0=torch.zeros(D),
              aggregator=VanillaASGD(), n_clients=N, server_lr=LR, beta=BETA,
              seed=SEED, device="cpu")
    with pytest.raises(ValueError, match="k_batch"):
        StalenessSimulator(k_batch=N + 1, **kw)
    with pytest.raises(ValueError, match="replay"):
        StalenessSimulator(k_batch=4, **kw)
    rand = build_staleness_randomness(SEED, 30, N, BETA, k_batch=4,
                                      device="cpu")
    flat = build_fault_schedule(0, 30, nan_rate=0.1, device="cpu")
    sim = StalenessSimulator(k_batch=4, replay=rand, faults=flat,
                             clip_norm=5.0, **kw)
    with pytest.raises(ValueError, match="fault schedule"):
        sim.run(30)


@pytest.mark.parametrize("dtype,code", [("int8", 1), ("float32", 4)])
def test_nbytes_counts_every_state_tensor(dtype, code):
    """The cache's codes and scales plus the running vectors and counters
    (Table a.3's server memory)."""
    init = torch.randn((N, D))
    cache = N * D * code + N * 4
    ace = ACEIncremental(cache_dtype=dtype)
    assert ace.nbytes(ace.init_state(N, D, init, "cpu")) == cache + D * 4
    # + t_start (n,) i32, the (τ_algo + 2,) i32 ring, asum and init_sum,
    # three 0-d i32 counters and the (n,) bool init mask
    aced = ACED(tau_algo=5, cache_dtype=dtype)
    assert aced.nbytes(aced.init_state(N, D, init, "cpu")) == (
        cache + N * 4 + 7 * 4 + 2 * D * 4 + 3 * 4 + N)
    assert VanillaASGD().nbytes(VanillaASGD().init_state(N, D)) == 0
