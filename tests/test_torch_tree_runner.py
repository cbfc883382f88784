"""The tree layout of the port's staleness engine beyond one clean run:
against the port's own flat layout and host reference, the int8 history
ring, the layout guards, faults with the clip and resync, the chunked
runner, the eval cadence and the sanitize checks — on the narrow vision
MLP of tests/test_torch_tree_engine.py (six leaves), against the JAX
package's ``layout="tree"`` where JAX has the same run."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import build_fault_schedule as jax_schedule  # noqa: E402
from repro.core.scan_staleness import run_staleness_scan as jax_run  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import StalenessSimulator  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core.scan_staleness import (FaultSchedule,  # noqa: E402
                                             build_payload_noise,
                                             build_staleness_randomness,
                                             make_chunked_staleness_runner,
                                             make_staleness_runner)
from repro_torch.core.scan_staleness import run_staleness_scan as torch_run  # noqa: E402
from test_torch_engine import jax_vision_grad, replay_streams  # noqa: E402
from test_torch_tree_engine import (BETA, LR, SEED, T, VISION,  # noqa: E402
                                    make_rule, shared_grad, tasks)

torch.set_num_threads(1)
N = VISION["n_clients"]


def _streams(ttask, K, E, seed=SEED):
    return (build_staleness_randomness(seed, E, N, BETA, k_batch=K,
                                       device="cpu"),
            build_payload_noise(ttask.grad_fn, seed, E, N, K, device="cpu"))


def _same_tree(a, b):
    """Two structures (models, states, carries) bit for bit."""
    la, lb = convert.leaves(a), convert.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_tree_f32_matches_flat_and_the_host(name, K):
    """On the port's own streams: the tree run (f32 caches and ring) ends
    within 1e-5 of the flat run, emitting at the same ticks, and of the
    flat host reference `StalenessSimulator` through `ravel`."""
    _, ttask, params0 = tasks()
    E = default_n_events(make_rule("torch", name, "float32", K), T)
    rand, noise = _streams(ttask, K, E)
    kw = dict(grad_fn=ttask.grad_fn, params0=params0, n_clients=N,
              server_lr=LR, T=T, beta=BETA, k_batch=K, device="cpu",
              randomness=rand, payload_noise=noise)
    tree = torch_run(aggregator=make_rule("torch", name, "float32", K),
                     layout="tree", **kw)
    flat = torch_run(aggregator=make_rule("torch", name, "float32", K), **kw)
    assert tree.w.shape == flat.w.shape == (180,)
    assert np.array_equal(tree.emit, flat.emit)
    assert np.array_equal(tree.ts, flat.ts)
    assert np.max(np.abs(tree.w - flat.w)) <= 1e-5
    np.testing.assert_allclose(tree.losses, flat.losses, rtol=1e-5,
                               atol=1e-5)
    sim = StalenessSimulator(
        grad_fn=ttask.grad_fn, params0=params0,
        aggregator=make_rule("torch", name, "float32", K), n_clients=N,
        server_lr=LR, beta=BETA, replay=rand, payload_noise=noise,
        k_batch=K, device="cpu")
    host = sim.run(T)
    assert np.array_equal(tree.ts, np.asarray(host.ts))
    assert np.max(np.abs(tree.w - sim.w.numpy())) <= 1e-5


def test_int8_history_ring_matches_jax_and_stays_close():
    """``history_dtype="int8"``: the stale models are read back from int8
    rows, one scale per leaf. Against JAX's int8 ring (the client gradient
    shared, as for the int8 caches of tests/test_torch_tree_engine.py):
    within 1e-5; against the port's f32 ring on the same streams: within
    5% relative in norm (tests/test_train_scan.py's bound), losses
    finite."""
    jtask, ttask, params0 = tasks()
    _, noise_of = jax_vision_grad(VISION)
    agg = make_rule("jax", "ace", "float32", 1)
    E = default_n_events(agg, T)
    kw = dict(n_clients=N, server_lr=LR, T=T, beta=BETA, n_events=E,
              seed=SEED, layout="tree")
    jr = jax_run(grad_fn=shared_grad(ttask), params0=jtask.params0,
                 aggregator=agg, history_dtype="int8", **kw)
    rand, noise = replay_streams(SEED, E, N, BETA, 1, noise_of,
                                 (VISION["batch"],), True)
    tkw = dict(kw, grad_fn=ttask.grad_fn, params0=params0, device="cpu",
               randomness=rand, payload_noise=noise)
    q = torch_run(aggregator=make_rule("torch", "ace", "float32", 1),
                  history_dtype="int8", **tkw)
    f32 = torch_run(aggregator=make_rule("torch", "ace", "float32", 1), **tkw)
    assert np.array_equal(q.ts, np.asarray(jr.ts))
    assert np.max(np.abs(q.w - np.asarray(jr.w))) <= 1e-5
    assert np.all(np.isfinite(q.losses))
    assert not np.array_equal(q.w, f32.w)          # the ring is quantized
    # the norm bound of tests/test_train_scan.py; its per-element bound
    # (5% of max|w|) is not held here: on this 180-weight MLP at lr 0.2 one
    # weight moves 0.12 of 1.46, as in JAX's own int8 ring (equal above)
    rel = np.linalg.norm(q.w - f32.w) / np.linalg.norm(f32.w)
    assert rel < 0.05, rel
    # a bf16 ring runs too, and its ring holds bf16 rows
    r = make_staleness_runner(grad_fn=ttask.grad_fn, params0=params0,
                              aggregator=make_rule("torch", "ace", "int8", 1),
                              n_clients=N, T=T, beta=BETA, layout="tree",
                              history_dtype="bfloat16", device="cpu")
    r(rand, noise, LR)
    ring = r.carry["ring"]
    assert tcache.is_tree_cache(ring)
    assert all(t.dtype == torch.bfloat16
               for t in tcache.cache_tensors(ring))


def test_layout_guards():
    """JAX's guards, raised up front: an int8 ring on the flat layout,
    `record_w` on the tree layout, an unknown layout."""
    _, ttask, params0 = tasks()
    kw = dict(grad_fn=ttask.grad_fn, params0=params0,
              aggregator=make_rule("torch", "asgd", None, 1), n_clients=N,
              T=T, beta=BETA, device="cpu")
    with pytest.raises(ValueError, match="tree-layout only"):
        make_staleness_runner(layout="flat", history_dtype="int8", **kw)
    with pytest.raises(ValueError, match="flat-layout only"):
        make_staleness_runner(layout="tree", record_w=True, **kw)
    with pytest.raises(ValueError, match="unknown layout"):
        make_staleness_runner(layout="ring", **kw)
    with pytest.raises(ValueError, match="flat-layout only"):
        torch_run(layout="tree", record_w=True, server_lr=LR, **kw)


RATES = dict(nan_rate=0.1, explode_rate=0.08, byzantine_rate=0.05,
             overstale_rate=0.08)


@pytest.mark.parametrize("name,K", [("aced", 1), ("ca2fl", 3)])
def test_faulted_tree_run_matches_jax(name, K):
    """Faults (NaN, exploding, Byzantine, over-stale), the clip and resync
    every 3rd update on the tree layout: the guard stage per leaf (the
    multiplier, the finite check over every leaf, the global norm, the
    clip), each quarantined or rejected arrival undone on the tree cache.
    Against JAX's faulted ``layout="tree"`` run: within 1e-5, the guard
    counters identical and every guard fired."""
    jtask, ttask, params0 = tasks()
    jgrad, noise_of = jax_vision_grad(VISION)
    agg = make_rule("jax", name, "float32", K)
    E = default_n_events(agg, T) + 40
    jf = jax_schedule(SEED, E, k_batch=K, **RATES)
    clip = 1.0
    kw = dict(n_clients=N, server_lr=LR, T=T, beta=BETA, n_events=E,
              seed=SEED, k_batch=K, layout="tree", clip_norm=clip,
              resync_every=3)
    jr = jax_run(grad_fn=jgrad, params0=jtask.params0, aggregator=agg,
                 faults=jf, **kw)
    rand, noise = replay_streams(SEED, E, N, BETA, K, noise_of,
                                 (VISION["batch"],),
                                 jagg.wants_cache_init(agg))
    faults = FaultSchedule(torch.as_tensor(np.array(jf.kind)),
                           torch.as_tensor(np.array(jf.scale)))
    tr = torch_run(grad_fn=ttask.grad_fn, params0=params0,
                   aggregator=make_rule("torch", name, "float32", K),
                   device="cpu", randomness=rand, payload_noise=noise,
                   faults=faults, **kw)
    assert np.isfinite(tr.w).all()
    assert tr.faults == jr.faults
    assert all(v > 0 for v in tr.faults.values()), tr.faults
    assert np.array_equal(tr.emit, jr.emit)
    assert np.array_equal(tr.ts, jr.ts)
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    np.testing.assert_allclose(tr.update_norms, jr.update_norms, rtol=1e-5,
                               atol=1e-5)


def test_chunked_tree_runner_matches_one_run():
    """The chunked tree runner over slices of 13 events (a partial tail
    chunk), the carry — tree model, tree caches, the int8 ring, per-leaf
    snapshots — saved with torch.save and loaded mid-run: bit for bit the
    one run's model, state, outputs and snapshots."""
    _, ttask, params0 = tasks()
    K, C = 3, 13
    E = default_n_events(make_rule("torch", "aced", "int8", K), T)
    assert E % C != 0
    rand, noise = _streams(ttask, K, E)
    kw = dict(grad_fn=ttask.grad_fn, params0=params0, n_clients=N, T=T,
              beta=BETA, k_batch=K, layout="tree", history_dtype="int8",
              eval_marks=(4, 8, 12), device="cpu")
    w, state, outs, extras = make_staleness_runner(
        aggregator=make_rule("torch", "aced", "int8", K), **kw)(
            rand, noise, LR)
    runner = make_chunked_staleness_runner(
        aggregator=make_rule("torch", "aced", "int8", K), capacity=C, **kw)
    assert runner.layout == "tree"
    carry, parts = runner.init(LR, noise.init), []
    for a in range(0, E, C):
        b = min(a + C, E)
        carry, o = runner.chunk(carry, rand.slice(a, b), noise.ticks[a:b],
                                LR)
        parts.append(o)
        if a == C:                      # a checkpoint mid-run
            buf = io.BytesIO()
            torch.save(carry, buf)
            buf.seek(0)
            carry = torch.load(buf)
    assert int(carry["e"]) == E
    assert isinstance(carry["w"], list)
    _same_tree(carry["w"], w)
    _same_tree(carry["state"], state)
    for k in outs:
        assert torch.equal(torch.cat([p[k] for p in parts]), outs[k])
    _same_tree(carry["snaps"], extras["snaps"])
    assert torch.equal(carry["hits"], extras["hits"])


def test_tree_evals_equal_flat_evals():
    """The eval cadence on the tree layout snapshots the parameter
    structure per leaf: its evals and marks are the flat run's."""
    _, ttask, params0 = tasks()
    E = default_n_events(make_rule("torch", "aced", "float32", 1), T)
    rand, noise = _streams(ttask, 1, E)
    kw = dict(grad_fn=ttask.grad_fn, params0=params0, n_clients=N,
              server_lr=LR, T=T, beta=BETA, eval_fn=ttask.eval_fn,
              eval_every=4, device="cpu", randomness=rand,
              payload_noise=noise)
    tree = torch_run(aggregator=make_rule("torch", "aced", "float32", 1),
                     layout="tree", **kw)
    flat = torch_run(aggregator=make_rule("torch", "aced", "float32", 1),
                     **kw)
    assert tree.eval_ts == flat.eval_ts == [4, 8, 12]
    assert tree.evals == flat.evals


def test_tree_checks_on_equal_off_and_nan_model_raises():
    """The sanitize checks over tree leaves: on, a faulted tree run with
    resync is bit-identical to off; a NaN in one leaf of params0 raises
    'non-finite server model'."""
    _, ttask, params0 = tasks()
    K = 3
    E = default_n_events(make_rule("torch", "aced", "int8", K), T) + 20
    rand, noise = _streams(ttask, K, E)
    from repro_torch.core import build_fault_schedule
    faults = build_fault_schedule(SEED, E, k_batch=K, device="cpu", **RATES)
    kw = dict(grad_fn=ttask.grad_fn, params0=params0, n_clients=N, T=T,
              beta=BETA, k_batch=K, layout="tree", guards=True,
              resync_every=3, device="cpu")
    runs = [make_staleness_runner(
        aggregator=make_rule("torch", "aced", "int8", K),
        checkify_invariants=on, **kw)(rand, noise, LR, faults, 1.0)
        for on in (False, True)]
    (w0, s0, o0, x0), (w1, s1, o1, x1) = runs
    _same_tree(w0, w1)
    _same_tree(s0, s1)
    assert all(torch.equal(o0[k], o1[k]) for k in o0)
    _same_tree(x0["guards"], x1["guards"])
    bad = convert.tree_map(lambda x: x.clone(), params0)
    bad[1]["w"][0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite server model"):
        make_staleness_runner(
            aggregator=make_rule("torch", "ace", "float32", 1),
            checkify_invariants=True,
            **{**kw, "params0": bad, "k_batch": 1, "guards": False})(
                *_streams(ttask, 1, 30), LR)


@pytest.mark.parametrize("layout", ["flat", "tree", "event", "host"])
def test_bf16_state_update_is_applied_in_f32_as_jax(layout):
    """A bf16 `state_dtype` ACE hands its engine the bf16 running mean as
    the update; every engine (the staleness engine in both layouts, the
    event engine) and the host reference apply it in f32, as JAX's do:
    within 1e-5 of JAX's run on the same streams, where a bf16 product η·u
    was 6e-3 away (ROADMAP §C, C9)."""
    from repro.core import delays as jdelays
    from repro.core.scan_engine import run_scan as jax_scan
    from repro_torch.core import aggregators as tagg
    from repro_torch.core import delays as tdelays
    from repro_torch.core.scan_engine import run_scan as torch_scan
    from test_torch_engine import D as QD
    from test_torch_engine import N as QN
    from test_torch_engine import quadratic

    def rule(mod):
        return mod.ACEIncremental(state_dtype="bfloat16")
    if layout == "event":
        jax_grad, torch_grad, noise_of = quadratic()
        qT, seed = 14, 2
        E = default_n_events(rule(jagg), qT)
        kw = dict(n_clients=QN, server_lr=0.1, T=qT, seed=seed,
                  record_w=True)
        jr = jax_scan(grad_fn=jax_grad, params0=jnp.ones(QD),
                      aggregator=rule(jagg),
                      delays=jdelays.ExponentialDelays(
                          beta=2.0, kappa=2.0, n_clients=QN, seed=seed), **kw)
        noise = replay_streams(seed, E, QN, 2.0, 1, noise_of, (QD,), True)[1]
        tr = torch_scan(grad_fn=torch_grad, params0=torch.ones(QD),
                        aggregator=rule(tagg),
                        delays=tdelays.ExponentialDelays(
                            beta=2.0, kappa=2.0, n_clients=QN, seed=seed),
                        device="cpu", payload_noise=noise, **kw)
        assert np.array_equal(tr.ts, jr.ts)
        assert np.max(np.abs(tr.ws - np.asarray(jr.ws))) <= 1e-5
        return
    jtask, ttask, params0 = tasks()
    jgrad, noise_of = jax_vision_grad(VISION)
    E = default_n_events(rule(jagg), T)
    kw = dict(n_clients=N, server_lr=LR, T=T, beta=BETA, n_events=E,
              seed=SEED)
    jr = jax_run(grad_fn=jgrad, params0=jtask.params0, aggregator=rule(jagg),
                 layout="flat" if layout == "host" else layout, **kw)
    rand, noise = replay_streams(SEED, E, N, BETA, 1, noise_of,
                                 (VISION["batch"],), True)
    if layout == "host":
        sim = StalenessSimulator(
            grad_fn=ttask.grad_fn, params0=params0, aggregator=rule(tagg),
            n_clients=N, server_lr=LR, beta=BETA, replay=rand,
            payload_noise=noise, device="cpu")
        ts, w = np.asarray(sim.run(T).ts), sim.w.numpy()
    else:
        tr = torch_run(grad_fn=ttask.grad_fn, params0=params0,
                       aggregator=rule(tagg), device="cpu", randomness=rand,
                       payload_noise=noise, layout=layout, **kw)
        ts, w = tr.ts, tr.w
    assert np.array_equal(ts, np.asarray(jr.ts))
    assert np.max(np.abs(w - np.asarray(jr.w))) <= 1e-5
