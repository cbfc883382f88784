"""The port's fault schedules, guard pipeline and periodic resync on the
CPU: against the JAX package's `run_staleness_scan(faults=...)` on the same
random streams and schedules (replayed as `tests/test_torch_engine.py`
replays the streams; the JAX schedules are carried across as tensors), and
against the port itself — the contracts of `tests/test_faults.py`.

Tolerances: the model within 1e-5 of the JAX package's after every tick
(the repo's contract between its engines), `emit`, `ts` and the guard
counters identical; bit for bit where the port is compared with itself (a
clean schedule against no guards, chunks against one run).
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import build_fault_schedule as jax_schedule  # noqa: E402
from repro.core.scan_staleness import run_staleness_scan as jax_run  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core.scan_staleness import (  # noqa: E402
    FaultSchedule, _fault_seed, build_fault_schedule, build_payload_noise,
    build_staleness_randomness, make_chunked_staleness_runner,
    make_staleness_runner, no_faults)
from repro_torch.core.scan_staleness import run_staleness_scan as torch_run  # noqa: E402
from repro_torch.core.staleness_sim import FAULT_NAN  # noqa: E402
from test_torch_engine import WINDOWS, N, D, quadratic, replay_streams  # noqa: E402
from test_torch_runner import _same_state  # noqa: E402

T, BETA, LR, SEED, TAU_MAX = 24, 2.0, 0.1, 1, 6
RATES = dict(nan_rate=0.08, explode_rate=0.05, byzantine_rate=0.05,
             overstale_rate=0.08)
CLIP = 5.0


def _rule(name, dtype, K, mod):
    """One rule of the zoo in the JAX package (`jagg`) or the port
    (`tagg`)."""
    return {"asgd": lambda: mod.VanillaASGD(),
            "fedbuff": lambda: mod.FedBuff(buffer_size=3),
            "ca2fl": lambda: mod.CA2FL(buffer_size=3, cache_dtype=dtype),
            "ace": lambda: mod.ACEIncremental(cache_dtype=dtype),
            "aced": lambda: mod.ACED(tau_algo=4, cache_dtype=dtype,
                                     max_cohort=K),
            "ca2fl_direct": lambda: mod.CA2FLDirect(buffer_size=3,
                                                    cache_dtype=dtype),
            "ace_direct": lambda: mod.ACEDirect(cache_dtype=dtype),
            "aced_direct": lambda: mod.ACEDDirect(tau_algo=4,
                                                  cache_dtype=dtype),
            }[name]()


def _n_events(agg):
    # quarantined and rejected events never emit: slack over the
    # guaranteed-emit budget (and the windows' freeze) so every faulted run
    # still reaches T
    return default_n_events(agg, T) + 60 + N


def _port(fa):
    """A JAX `FaultSchedule` as the port's."""
    return FaultSchedule(torch.as_tensor(np.array(fa.kind)),
                         torch.as_tensor(np.array(fa.scale)))


def _pair(name, dtype, K, jf=None, clip_norm=CLIP, resync_every=None,
          windows=WINDOWS, tau_max=TAU_MAX):
    """The same faulted run in both packages -> (JAX result, port result):
    JAX's schedule for SEED (or `jf`) and its streams, replayed."""
    jax_grad, torch_grad, noise_of = quadratic()
    j_agg = _rule(name, dtype, K, jagg)
    E = _n_events(j_agg)
    if jf is None:
        jf = jax_schedule(SEED, E, k_batch=K, **RATES)
    kw = dict(n_clients=N, server_lr=LR, T=T, beta=BETA, tau_max=tau_max,
              n_events=E, seed=SEED, k_batch=K, windows=windows,
              record_w=True, clip_norm=clip_norm, resync_every=resync_every)
    jr = jax_run(grad_fn=jax_grad, params0=jnp.ones(D), aggregator=j_agg,
                 faults=jf, **kw)
    rand, noise = replay_streams(SEED, E, N, BETA, K, noise_of, (D,),
                                 jagg.wants_cache_init(j_agg),
                                 windows=windows)
    tr = torch_run(grad_fn=torch_grad, params0=torch.ones(D),
                   aggregator=_rule(name, dtype, K, tagg), device="cpu",
                   randomness=rand, payload_noise=noise, faults=_port(jf),
                   **kw)
    return jr, tr


def _agree(jr, tr):
    assert np.isfinite(tr.w).all()
    assert np.array_equal(tr.emit, jr.emit)
    assert np.array_equal(tr.ts, jr.ts)
    assert tr.total_comms == jr.total_comms
    assert tr.faults == jr.faults
    # the whole trajectory, event by event
    assert np.max(np.abs(tr.ws - np.asarray(jr.ws))) <= 1e-5
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)


# --- the fault schedule ------------------------------------------------------

def test_fault_schedule_counts_and_validation():
    """The port's own draw: each kind at its rate over 4000 events, int32
    kinds and f32 scales, per-lane shapes at K > 1, slices; rates below 0
    or summing past 1 raise."""
    fa = build_fault_schedule(SEED, 4000, device="cpu", **RATES)
    assert fa.kind.dtype == torch.int32 and fa.scale.dtype == torch.float32
    assert fa.kind.shape == fa.scale.shape == (4000,)
    counts = fa.counts()
    assert set(counts) == {"nan", "explode", "byzantine", "overstale"}
    for kind, rate in (("nan", 0.08), ("explode", 0.05),
                       ("byzantine", 0.05), ("overstale", 0.08)):
        assert abs(counts[kind] / 4000 - rate) < 0.03, (kind, counts)
    assert no_faults(8, device="cpu").counts() == {
        "nan": 0, "explode": 0, "byzantine": 0, "overstale": 0}
    lanes = build_fault_schedule(SEED, 50, k_batch=4, device="cpu", **RATES)
    assert lanes.kind.shape == (50, 4) and lanes.n_events == 50
    part = lanes.slice(10, 30)
    assert part.n_events == 20 and torch.equal(part.kind, lanes.kind[10:30])
    with pytest.raises(ValueError):
        build_fault_schedule(0, 10, nan_rate=0.7, byzantine_rate=0.6,
                             device="cpu")
    with pytest.raises(ValueError):
        build_fault_schedule(0, 10, nan_rate=-0.1, device="cpu")


def test_port_schedule_leaves_the_protocol_streams_alone():
    """The schedule is drawn from a generator of its own: drawing it leaves
    the seed's gumbel and τ streams as they were, its seed is neither the
    seed nor seed + 201 (another seed's protocol stream), and a faulted run
    (no clip, no natural over-stale request) follows the clean run of the
    same seed bit for bit up to its first fault."""
    before = build_staleness_randomness(SEED, 80, N, BETA, device="cpu")
    fa = build_fault_schedule(SEED, 80, device="cpu", **RATES)
    after = build_staleness_randomness(SEED, 80, N, BETA, device="cpu")
    assert torch.equal(before.gumbels, after.gumbels)
    assert torch.equal(before.tau_raw, after.tau_raw)
    assert _fault_seed(SEED) not in (SEED, SEED + 201)
    assert not torch.equal(
        build_fault_schedule(SEED + 1, 80, device="cpu", **RATES).kind,
        fa.kind)
    def first_fault(schedule):
        return int(np.flatnonzero(schedule.kind.numpy() != 0)[0])
    # a seed whose schedule starts with a few clean events
    seed = next(s for s in range(SEED, SEED + 100) if first_fault(
        build_fault_schedule(s, 80, device="cpu", **RATES)) >= 4)
    fa = build_fault_schedule(seed, 80, device="cpu", **RATES)
    first = first_fault(fa)
    _, torch_grad, _ = quadratic()
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
              server_lr=LR, T=T, beta=BETA, seed=seed, n_events=80,
              record_w=True, device="cpu")
    clean = torch_run(aggregator=tagg.ACEIncremental(cache_dtype="int8"),
                      **kw)
    faulted = torch_run(aggregator=tagg.ACEIncremental(cache_dtype="int8"),
                        faults=fa, **kw)
    assert np.array_equal(clean.ws[:first], faulted.ws[:first])
    assert not np.array_equal(clean.w, faulted.w)


def test_schedule_mismatch_rejected():
    """A schedule of another event count, or one built for another k_batch,
    raises before the run; so do faults given to a runner built without
    guards."""
    _, torch_grad, _ = quadratic()
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
              server_lr=LR, T=T, beta=BETA, aggregator=tagg.VanillaASGD(),
              device="cpu")
    E = _n_events(jagg.VanillaASGD())
    with pytest.raises(ValueError, match="n_events"):
        torch_run(faults=no_faults(50, device="cpu"), n_events=E, **kw)
    with pytest.raises(ValueError, match="k_batch"):
        torch_run(faults=build_fault_schedule(SEED, E, device="cpu",
                                              **RATES), k_batch=3, **kw)
    runner = make_staleness_runner(
        grad_fn=torch_grad, params0=torch.ones(D),
        aggregator=tagg.VanillaASGD(), n_clients=N, T=T, beta=BETA,
        device="cpu")
    rand = build_staleness_randomness(SEED, 20, N, BETA, device="cpu")
    noise = build_payload_noise(torch_grad, SEED, 20, N, device="cpu")
    with pytest.raises(ValueError, match="guards"):
        runner(rand, noise, LR, no_faults(20, device="cpu"))
    with pytest.raises(ValueError, match="guards"):
        runner(rand, noise, LR, clip_norm=CLIP)
    guarded = make_staleness_runner(
        grad_fn=torch_grad, params0=torch.ones(D),
        aggregator=tagg.VanillaASGD(), n_clients=N, T=T, beta=BETA,
        guards=True, device="cpu")
    with pytest.raises(ValueError, match="k_batch"):
        guarded(rand, noise, LR, no_faults(20, k_batch=2, device="cpu"))


# --- guards are a no-op unless a fault fires ---------------------------------

@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "int8", 1),
                                          ("ca2fl", "float32", 1),
                                          ("ace", "int8", 4),
                                          ("aced", "float32", 4),
                                          ("ca2fl", "int8", 4)])
def test_clean_schedule_is_bit_exact(name, dtype, K):
    """A guarded runner on an all-clean schedule with the clip off ends bit
    for bit where the unguarded runner ends (model, every state tensor,
    every output they share), every flag 0: × 1.0 is an identity."""
    _, torch_grad, _ = quadratic()
    E = 60
    rand = build_staleness_randomness(SEED, E, N, BETA, windows=WINDOWS,
                                      k_batch=K, device="cpu")
    noise = build_payload_noise(torch_grad, SEED, E, N, K, device="cpu")
    # the default tau_max (32 at β = 2): no request is over-stale by
    # nature, which the guards would reject
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N, T=18,
              beta=BETA, k_batch=K, device="cpu")
    off = make_staleness_runner(aggregator=_rule(name, dtype, K, tagg),
                                **kw)(rand, noise, LR)
    on = make_staleness_runner(aggregator=_rule(name, dtype, K, tagg),
                               guards=True, **kw)(
        rand, noise, LR, no_faults(E, K, device="cpu"), 0.0)
    assert torch.equal(on[0], off[0])
    _same_state(on[1], off[1])
    for k in off[2]:
        assert torch.equal(on[2][k], off[2][k]), k
    for k in ("quarantined", "clipped", "rejected"):
        assert int(on[2][k].sum()) == 0 and int(on[3]["guards"][k]) == 0


# --- parity with the JAX package under injected faults -----------------------

PARITY = ([(r, "float32", K) for r in ("asgd", "fedbuff") for K in (1, 4)]
          + [(r, dt, K) for r in ("ca2fl", "ace", "aced")
             for dt in ("int8", "float32") for K in (1, 4)])


@pytest.mark.parametrize("name,dtype,K", PARITY)
def test_faulted_run_matches_jax(name, dtype, K):
    """NaN, exploding, Byzantine and over-stale clients under quarantine,
    clipping and rejection, with a freeze and thaw: the same trajectory
    within 1e-5, the same emissions and the same guard counters as the JAX
    package, a finite model, and every guard fired."""
    jr, tr = _pair(name, dtype, K)
    _agree(jr, tr)
    assert all(v > 0 for v in tr.faults.values()), tr.faults


def test_mixed_clean_nan_batch_quarantines_per_lane():
    """K = 3 with the lane pattern [clean, NaN, clean] on every tick: the
    NaN lane is quarantined alone, every tick still emits (the run reaches
    T − 1 updates after the init), one lane quarantined a tick, and the
    run follows the JAX package's within 1e-5."""
    k = 3
    E = _n_events(jagg.ACEIncremental())
    kind = np.zeros((E, k), np.int32)
    kind[:, 1] = FAULT_NAN
    from repro.core.scan_staleness import FaultSchedule as JaxSchedule
    jf = JaxSchedule(jnp.asarray(kind), jnp.ones((E, k), jnp.float32))
    jr, tr = _pair("ace", "float32", k, jf=jf, windows=None, tau_max=None)
    _agree(jr, tr)
    assert len(tr.ts) == T - 1
    assert tr.faults["quarantined"] == len(tr.ts)


# --- periodic resync ---------------------------------------------------------

@pytest.mark.parametrize("name,dtype,K", [("aced", "int8", 1),
                                          ("ca2fl", "int8", 1),
                                          ("ace", "int8", 4),
                                          ("aced", "float32", 4)])
def test_resync_run_matches_jax(name, dtype, K):
    """``resync_every = 3`` under faults: the recompute selected by
    ``torch.where`` gives what JAX's ``lax.cond`` gives, within 1e-5."""
    _agree(*_pair(name, dtype, K, resync_every=3))


@pytest.mark.parametrize("inc,direct", [("ace", "ace_direct"),
                                        ("aced", "aced_direct"),
                                        ("ca2fl", "ca2fl_direct")])
def test_resync_matches_direct_under_faults(inc, direct):
    """Inside the port, f32: each incremental rule with ``resync_every = 5``
    and its O(n·d) direct reference on one faulted stream end within 1e-5,
    with the same guard counters."""
    _, torch_grad, _ = quadratic()
    E = _n_events(_rule(direct, "float32", 1, jagg))
    kw = dict(grad_fn=torch_grad, params0=torch.ones(D), n_clients=N,
              server_lr=LR, T=T, beta=BETA, tau_max=TAU_MAX, seed=SEED,
              n_events=E, windows=WINDOWS, clip_norm=CLIP, device="cpu",
              faults=build_fault_schedule(SEED, E, device="cpu", **RATES))
    r_inc = torch_run(aggregator=_rule(inc, "float32", 1, tagg),
                      resync_every=5, **kw)
    r_dir = torch_run(aggregator=_rule(direct, "float32", 1, tagg), **kw)
    assert np.max(np.abs(r_inc.w - r_dir.w)) <= 1e-5
    assert np.array_equal(r_inc.emit, r_dir.emit)
    assert r_inc.faults == r_dir.faults and sum(r_inc.faults.values()) > 0


def _chunked(agg, resync_every, C, E, corrupt=None):
    """A guarded ACED run in chunks of C events over the port's own
    streams and schedule; `corrupt(carry)` between the first two."""
    _, torch_grad, _ = quadratic()
    rand = build_staleness_randomness(SEED, E, N, BETA, device="cpu")
    noise = build_payload_noise(torch_grad, SEED, E, N, device="cpu")
    fa = build_fault_schedule(SEED, E, device="cpu", **RATES)
    runner = make_chunked_staleness_runner(
        grad_fn=torch_grad, params0=torch.ones(D), aggregator=agg,
        n_clients=N, T=T, beta=BETA, guards=True, resync_every=resync_every,
        capacity=C, device="cpu")
    assert runner.guards and runner.resync_every == resync_every
    carry, parts = runner.init(LR, noise.init), []
    for i, a in enumerate(range(0, E, C)):
        if i == 1 and corrupt is not None:
            corrupt(carry)
        carry, o = runner.chunk(carry, rand.slice(a, a + C),
                                noise.ticks[a:a + C], LR, fa.slice(a, a + C),
                                CLIP)
        parts.append(o)
        buf = io.BytesIO()
        torch.save(carry, buf)
        buf.seek(0)
        carry = torch.load(buf)
    return carry, {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_resync_heals_corrupted_running_sum(dtype):
    """+100 on ACED's running active-set sum between two chunks: with
    ``resync_every`` the periodic recompute from the (never corrupted)
    cache heals it; without, it stays to the end of the run."""
    agg = tagg.ACED(tau_algo=4, cache_dtype=dtype)
    E = -(-_n_events(jagg.ACED(tau_algo=4)) // 20) * 20

    def corrupt(carry):
        carry["state"]["asum"] += 100.0
    for resync_every in (None, 4):
        carry, _ = _chunked(agg, resync_every, 20, E, corrupt)
        healed = agg.resync(carry["state"])
        drift = float((carry["state"]["asum"] - healed["asum"]).abs().max())
        if resync_every:
            assert drift <= 1e-4, drift
        else:
            assert drift > 50.0, drift


def test_fault_counters_survive_chunks_and_resume():
    """Guard counters are protocol state: after chunks with a torch.save /
    torch.load round trip between each, they equal one run's totals, as do
    the model, the state and every per-event output, bit for bit."""
    _, torch_grad, _ = quadratic()
    agg = tagg.ACED(tau_algo=4, cache_dtype="int8")
    C = 16
    E = -(-_n_events(jagg.ACED(tau_algo=4)) // C) * C
    rand = build_staleness_randomness(SEED, E, N, BETA, device="cpu")
    noise = build_payload_noise(torch_grad, SEED, E, N, device="cpu")
    fa = build_fault_schedule(SEED, E, device="cpu", **RATES)
    w, state, outs, extras = make_staleness_runner(
        grad_fn=torch_grad, params0=torch.ones(D), aggregator=agg,
        n_clients=N, T=T, beta=BETA, guards=True, resync_every=4,
        device="cpu")(rand, noise, LR, fa, CLIP)
    carry, chunk_outs = _chunked(agg, 4, C, E)
    want = {k: int(outs[k].sum()) for k in ("quarantined", "clipped",
                                             "rejected")}
    assert {k: int(v) for k, v in carry["guards"].items()} == want
    assert {k: int(v) for k, v in extras["guards"].items()} == want
    assert sum(want.values()) > 0
    assert torch.equal(carry["w"], w)
    _same_state(carry["state"], state)
    for k in outs:
        nan = torch.isnan(outs[k].float())
        assert torch.equal(nan, torch.isnan(chunk_outs[k].float()))
        assert torch.equal(outs[k][~nan], chunk_outs[k][~nan]), k
