"""The LM task (`repro_torch.core.make_lm_task`: a transformer of
`repro_torch.models` on the synthetic token stream) against the JAX
package's `make_lm_task`, on the reduced yi-9b of
tests/test_k_batch.py::test_tree_layout_k_batch_matches_host_on_lm_task
(2 layers, d_model 64, vocab 128; n = 4 clients, batch 2, seq 32, 2^14
tokens), the port fed JAX's weights through `convert.params_from_jax`:

  * the eval batch and the windows are JAX's (eval losses equal, lane
    losses and gradients within 1e-5 of JAX's `model.loss_fn` on the same
    windows, in the tree and the flat layout);
  * the tree-layout engine against JAX's ``layout="tree"`` runner on JAX's
    replayed streams (`jax_lm_grad` draws each lane's window uniforms from
    its key, as tests/test_torch_engine.py's `jax_vision_grad` draws the
    minibatch): ACED K = 3 and ACE K = 1 with f32 caches within 1e-5
    (model, losses, update norms, the rule's state); ACE int8 K = 1 with
    the port's gradient given to JAX through `jax.pure_callback`, every
    int8 code of the cache equal to JAX's or one step from it (ROADMAP
    §C, C11), and the port's int8 tree-cache mean equal to JAX's eager
    mean bit for bit;
  * inside the port: its `StalenessSimulator` equal to its tree engine
    (ACED K = 3, the counterpart of the JAX test above), a flat-layout ACE
    run equal to the tree run, and the int8 history ring within
    tests/test_train_scan.py::test_int8_history_ring_stays_close's bounds
    of the f32 ring, in norm and per element (ROADMAP §C, C8).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import make_staleness_runner as jax_runner  # noqa: E402
from repro.data.synthetic import make_token_stream  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.scan_staleness import make_staleness_runner as torch_runner  # noqa: E402
from repro_torch.core.scan_staleness import run_staleness_scan  # noqa: E402
from repro_torch.core.staleness_sim import StalenessSimulator  # noqa: E402
from test_torch_engine import replay_streams  # noqa: E402
from test_torch_tree_engine import close  # noqa: E402

torch.set_num_threads(1)

CFG = jget_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
TASK = dict(n_clients=4, batch=2, seq=32, n_tokens=1 << 14, seed=0)
N, T, BETA, LR, SEED = 4, 12, 3.0, 0.05, 0


@functools.lru_cache(maxsize=None)
def tasks(cfg=CFG):
    """(JAX task, the port's task, JAX's params0 as the port's) of the LM
    task on `cfg` (the JAX package's configuration)."""
    jtask = jtasks.make_lm_task(cfg=cfg, **TASK)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    ttask = ttasks.make_lm_task(cfg=tcfg, device="cpu", **TASK)
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    return jtask, ttask, params0


def jax_lm_grad(cfg=CFG):
    """JAX's LM gradient built from the JAX package's pieces, drawing each
    call's window uniforms from its key and starting window i at ``lo +
    min(floor(u_i · (per − seq − 1)), per − seq − 2)`` — the port's rule —
    so that both packages read the same windows. -> (grad_fn, noise_of)."""
    seq, batch = TASK["seq"], TASK["batch"]
    toks = jnp.asarray(make_token_stream(n_tokens=TASK["n_tokens"],
                                         vocab=cfg.vocab_size,
                                         seed=TASK["seed"]), jnp.int32)
    per = TASK["n_tokens"] // TASK["n_clients"]
    model = jbuild(cfg)

    def grad_fn(params, client, key):
        u = jax.random.uniform(key, (batch,))
        starts = client * per + jnp.minimum(
            jnp.floor(u * (per - seq - 1)).astype(jnp.int32), per - seq - 2)
        window = toks[starts[:, None] + jnp.arange(seq + 1)[None, :]]
        b = {"tokens": window[:, :-1], "targets": window[:, 1:]}
        return jax.value_and_grad(lambda p: model.loss_fn(p, b))(params)
    return grad_fn, lambda key: jax.random.uniform(key, (batch,))


def lanes(params0, B, seed=3):
    """B lanes of the model: w⁰, then w⁰ moved by small draws (numpy)."""
    rng = np.random.default_rng(seed)
    return [params0] + [convert.tree_map(
        lambda x: x + torch.as_tensor(rng.normal(size=tuple(x.shape)) * 0.01,
                                      dtype=torch.float32), params0)
        for _ in range(B - 1)]


def test_eval_batch_and_stream_are_jaxs():
    jtask, ttask, params0 = tasks()
    assert ttask.meta == jtask.meta == {"kind": "lm", "model": CFG.name,
                                        "params": CFG.param_count()}
    assert ttask.n_clients == jtask.n_clients == N
    for p_t, p_j in ((params0, jtask.params0),):
        assert ttask.eval_fn(p_t)["loss"] == pytest.approx(
            jtask.eval_fn(p_j)["loss"], rel=1e-6)
    # the port's own weights: the tree JAX builds, drawn anew
    assert [tuple(x.shape) for x in convert.leaves(ttask.params0)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jtask.params0)]
    assert abs(ttask.eval_fn(ttask.params0)["loss"]
               - np.log(CFG.vocab_size)) < 0.5


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_lane_losses_and_gradients_match_jax(layout):
    """Three lanes (three models, clients, window draws) of the port's
    batched gradient against JAX's value_and_grad on each lane."""
    _, ttask, params0 = tasks()
    jgrad, noise_of = jax_lm_grad()
    models = lanes(params0, 3)
    clients = np.array([0, 3, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    u = np.stack([np.asarray(noise_of(k)) for k in keys])
    stacked = convert.tree_map(lambda *xs: torch.stack(xs), *models)
    w = stacked if layout == "tree" else torch.stack(
        [convert.ravel(m) for m in models])
    loss, g = ttask.grad_fn(w, torch.as_tensor(clients), torch.as_tensor(u))
    assert loss.shape == (3,)
    for b in range(3):
        jp = jax.tree.map(jnp.asarray, convert.tree_map(
            lambda x: x.numpy(), models[b]))
        jl, jg = jgrad(jp, jnp.int32(clients[b]), keys[b])
        assert float(loss[b]) == pytest.approx(float(jl), abs=1e-5)
        gb = (convert.tree_map(lambda x: x[b], g) if layout == "tree"
              else convert.unravel(g[b], params0))
        close(gb, jg)


def make_rule(lib, name, dtype, K):
    mod = tagg if lib == "torch" else jagg
    if name == "ace":
        return mod.ACEIncremental(cache_dtype=dtype)
    return mod.ACED(tau_algo=5, cache_dtype=dtype, max_cohort=K)


def port_grad_in_jax(ttask):
    """The port's LM gradient as a JAX client gradient ``(params, client,
    key) -> (loss, grads)`` through `jax.pure_callback`, the window
    uniforms drawn from `key` as `jax_lm_grad` draws them."""
    batch = TASK["batch"]

    def host(params, client, u):
        p = convert.tree_map(lambda x: torch.as_tensor(np.array(x))[None],
                             params)
        loss, g = ttask.grad_fn(p, torch.as_tensor(np.array(client)
                                                   ).reshape(1),
                                torch.as_tensor(np.array(u))[None])
        return (np.float32(loss[0].numpy()),
                convert.tree_map(lambda x: x[0].numpy(), g))

    def grad_fn(params, client, key):
        u = jax.random.uniform(key, (batch,))
        shapes = (jax.ShapeDtypeStruct((), jnp.float32),
                  jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                      x.shape, jnp.float32), params))
        return jax.pure_callback(host, shapes, params, client, u,
                                 vmap_method="sequential")
    return grad_fn


@functools.lru_cache(maxsize=None)
def both_runs(name, dtype, K, cfg=CFG):
    """JAX's tree runner and the port's on JAX's streams -> (JAX's (w,
    state, outs) as numpy, the port's (w, state, outs)). An int8 run gives
    JAX the port's gradient."""
    jtask, ttask, params0 = tasks(cfg)
    jgrad, noise_of = jax_lm_grad(cfg)
    if dtype == "int8":
        jgrad = port_grad_in_jax(ttask)
    j_agg = make_rule("jax", name, dtype, K)
    n_events = default_n_events(j_agg, T)
    kw = dict(n_clients=N, T=T, beta=BETA, k_batch=K, layout="tree")
    jrun = jax_runner(grad_fn=jgrad, params0=jtask.params0, aggregator=j_agg,
                      **kw)
    rand, noise = replay_streams(SEED, n_events, N, BETA, K, noise_of,
                                 (TASK["batch"],),
                                 jagg.wants_cache_init(j_agg))
    jw, js, jouts, _ = jrun(jax.random.PRNGKey(SEED),
                            *(jnp.asarray(x) for x in (rand.gumbels,
                                                       rand.tau_raw,
                                                       rand.leave_at,
                                                       rand.rejoin_at)),
                            jnp.float32(LR))
    trun = torch_runner(grad_fn=ttask.grad_fn, params0=params0,
                        aggregator=make_rule("torch", name, dtype, K),
                        device="cpu", **kw)
    return (jax.tree.map(np.asarray, (jw, js, jouts)),
            trun(rand, noise, LR)[:3], (rand, noise))


def check_tree_run(jax_run, port_run):
    """The port's tree run against JAX's, both `both_runs` results: the
    model, the ticks, losses and update norms, and every state tensor
    within 1e-5."""
    (jw, js, jouts), (tw, ts, touts) = jax_run, port_run
    close(tw, jw)
    assert np.array_equal(touts["emit"].numpy(), jouts["emit"])
    assert np.array_equal(touts["t"].numpy(), jouts["t"])
    np.testing.assert_allclose(touts["loss"].numpy(), jouts["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(touts["unorm"].numpy(), jouts["unorm"],
                               rtol=1e-5, atol=1e-5)
    assert sorted(ts) == sorted(js)
    for k in ts:
        if tcache.is_tree_cache(ts[k]):
            close(tcache.cache_tensors(ts[k]), js[k])
        else:
            close(ts[k], js[k])


@pytest.mark.parametrize("name,K", [("aced", 3), ("ace", 1)])
def test_tree_engine_matches_jax_tree(name, K):
    jax_run, port_run, _ = both_runs(name, "float32", K)
    assert len(convert.leaves(port_run[0])) == 11
    check_tree_run(jax_run, port_run)


def test_int8_tree_mean_is_jaxs_eager_mean_bit_for_bit():
    """The port's int8 tree-cache mean equals the JAX package's
    `tree_cache_mean` run eagerly, bit for bit (both form q·s, round, then
    sum the rows in order). JAX's jitted engine fuses ``sum(q·s)`` and
    rounds otherwise: a share of its elements differ from the eager mean by
    an ulp (ROADMAP §C, C11)."""
    from repro.core import cache as jcache
    rng = np.random.default_rng(0)
    rows = (rng.normal(size=(4, 64, 128))
            * rng.uniform(0.01, 3.0, size=(4, 1, 1))).astype(np.float32)
    jc = jcache.init_tree_cache(4, {"a": jnp.zeros((64, 128))}, "int8",
                                init_rows={"a": jnp.asarray(rows)})
    tc = convert.tree_cache_from_jax(jc)
    eager = np.asarray(jcache.tree_cache_mean(jc)["a"])
    jitted = np.asarray(jax.jit(jcache.tree_cache_mean)(jc)["a"])
    port = tcache.tree_cache_mean(tc)["a"].numpy()
    assert np.array_equal(port, eager)
    assert np.max(np.abs(port - jitted)) <= 1e-6 * np.abs(eager).max()


def test_int8_tree_engine_matches_jax_to_a_code_step():
    """ACE with an int8 tree cache, both engines on the port's gradient
    (`jax.pure_callback`): the same ticks and losses; every int8 code of
    the cache equal to JAX's or one step from it, at most one in 10⁴ of
    them one step off (ROADMAP §C, C11: the engines' f32 sums differ by an
    ulp, which moves a payload lying at a rounding boundary by a code);
    the scales within 1e-5; the model within what those steps move it,
    T · lr · max(scale) / n."""
    (jw, js, jouts), (tw, ts, touts), _ = both_runs("ace", "int8", 1)
    assert np.array_equal(touts["emit"].numpy(), jouts["emit"])
    np.testing.assert_allclose(touts["loss"].numpy(), jouts["loss"],
                               rtol=1e-5, atol=1e-5)
    off = total = 0
    for a, b in zip(tcache.cache_tensors(ts["cache"]),
                    jax.tree.leaves(js["cache"])):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.int8:
            step = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert step.max() <= 1
            off, total = off + int(step.sum()), total + step.size
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert off <= total * 1e-4, (off, total)
    scale = max(float(np.max(b)) for b in jax.tree.leaves(js["cache"])
                if b.dtype == np.float32)
    bound = T * LR * scale / N
    dw = max(float(np.abs(a.numpy() - np.asarray(b)).max())
             for a, b in zip(convert.leaves(tw), jax.tree.leaves(jw)))
    assert dw <= bound, (dw, bound)


def test_host_reference_matches_the_tree_engine():
    """The port's `StalenessSimulator` (flat: the raveled model, the task's
    gradient in its flat layout) on the engine's streams against the tree
    engine, ACED K = 3: the same ticks, the models within 1e-5."""
    _, ttask, params0 = tasks()
    _, (tw, _, touts), (rand, noise) = both_runs("aced", "float32", 3)
    sim = StalenessSimulator(
        grad_fn=ttask.grad_fn, params0=params0,
        aggregator=make_rule("torch", "aced", "float32", 3), n_clients=N,
        server_lr=LR, beta=BETA, seed=SEED, replay=rand, payload_noise=noise,
        k_batch=3, device="cpu")
    hr = sim.run(T)
    emitted = touts["t"].numpy()[touts["emit"].numpy()]
    assert list(hr.ts) == list(emitted)
    w_engine = convert.ravel(tw).numpy()
    assert np.max(np.abs(np.asarray(sim.w) - w_engine)) <= 1e-5


def test_flat_layout_run_matches_the_tree_run():
    """ACE K = 1 on the flat layout (the raveled model, a `FlatCache`) on
    the same streams: the tree run's model within 1e-5, the same losses."""
    _, ttask, params0 = tasks()
    _, (tw, _, touts), (rand, noise) = both_runs("ace", "float32", 1)
    run = torch_runner(grad_fn=ttask.grad_fn, params0=params0,
                       aggregator=make_rule("torch", "ace", "float32", 1),
                       n_clients=N, T=T, beta=BETA, device="cpu")
    fw, _, fouts, _ = run(rand, noise, LR)
    assert fw.shape == (convert.ravel(params0).numel(),)
    assert float((fw - convert.ravel(tw)).abs().max()) <= 1e-5
    np.testing.assert_allclose(fouts["loss"].numpy(), touts["loss"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_int8_history_ring_stays_close():
    """tests/test_train_scan.py::test_int8_history_ring_stays_close on the
    port's LM task (its own weights and streams): the int8 ring's final
    model within 5% of the f32 ring's in norm and per element (5% of
    max|w|), all losses finite."""
    _, ttask, _ = tasks()
    kw = dict(grad_fn=ttask.grad_fn, params0=ttask.params0,
              aggregator=None, n_clients=N, server_lr=LR, T=16, beta=BETA,
              seed=SEED, layout="tree", device="cpu")
    kw["aggregator"] = tagg.ACEIncremental()
    f32 = run_staleness_scan(**kw)
    kw["aggregator"] = tagg.ACEIncremental()
    q = run_staleness_scan(history_dtype="int8", **kw)
    assert np.all(np.isfinite(q.losses))
    assert not np.array_equal(q.w, f32.w)
    rel = np.linalg.norm(q.w - f32.w) / np.linalg.norm(f32.w)
    assert rel < 0.05, rel
    assert np.max(np.abs(q.w - f32.w)) < 0.05 * np.max(np.abs(f32.w))


@pytest.mark.parametrize("n", [1, 8, 16])
def test_quant_plans_at_full_width_leaves(n):
    """The launch plans of the quant kernels at yi-9b's largest leaf, the
    64,000 × 4,096 embedding (262,144,000 numbers), by the rows a run
    writes and reads — 16 rows (`AFL_SIZING`'s n) hold 4.19·10⁹ codes,
    past 2³¹ — computed without allocating: every product in 64 bits, the
    dequantizer's grid covering every vector; the quantizer's rows on its
    cooperative grid by 1 and 8 rows (the card's 528 co-resident blocks
    split over them, 8 loads a thread in flight), by 16 each row one
    cluster of 8 blocks streaming its slice (128 of the 132 SMs)."""
    from repro_torch.kernels import quant as kq
    d = 64000 * 4096
    assert kq._quant_plan(n, d, 132) == (
        (8, 1024, 4, "stream") if n == 16 else (528 // n, 256, 8, "grid"))
    head, width, vec_q, threads, blocks = kq._dequant_plan(
        n, d, 1 << 20, 1 << 24)
    assert (head, width, vec_q, threads) == (0, 4, True, 256)
    assert blocks < 1 << 31
    assert blocks * threads * width >= n * d > (n > 8) * (1 << 31)


def test_aced_sweep_slot_by_slot_equals_all_at_once(monkeypatch):
    """ACED K = 3's expiry sweep gathers its slots' rows within
    `SWEEP_BYTES` a gather: all at once here, one slot at a time (JAX's
    loop) at a real model's width. Forced to one slot a gather, the run is
    the same, bit for bit."""
    _, ttask, params0 = tasks()
    _, _, (rand, noise) = both_runs("aced", "float32", 3)

    def run():
        r = torch_runner(grad_fn=ttask.grad_fn, params0=params0,
                         aggregator=make_rule("torch", "aced", "int8", 3),
                         n_clients=N, T=T, beta=BETA, k_batch=3,
                         layout="tree", history_dtype="int8", device="cpu")
        return r(rand, noise, LR)
    whole = run()
    monkeypatch.setattr(tagg, "SWEEP_BYTES", 1)
    by_slot = run()
    for a, b in zip(convert.leaves(whole[:3]), convert.leaves(by_slot[:3])):
        assert torch.equal(a, b)
