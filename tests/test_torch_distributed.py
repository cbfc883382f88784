"""The port's AFL train step (`repro_torch.core.distributed`) against the
JAX package's `repro.core.distributed`, on the CPU:

  * tests/test_distributed.py on the port: the train step over a parameter
    structure against the flat rule's `on_arrival` for ACE, ACE-direct,
    ACED, FedBuff and CA²FL (within 1e-5), the int8 tree cache's running
    mean invariant, and int8 ACE tracking f32 ACE;
  * the port's `make_afl_train_step` against JAX's on the same quadratic
    loss, batches, clients and staleness, for the same five rules and
    delay-adaptive ASGD: parameters, metrics and the rule's state within
    1e-5 at every step;
  * on the reduced yi LM loss with JAX's weights (`convert.params_from_jax`):
    ACE and ACED with f32 caches within 1e-5 after 6 steps; ACE with an int8
    cache, every int8 code equal to JAX's or one step from it (ROADMAP §C,
    C11);
  * `afl_state_bytes` and `history_ring_bytes` equal to JAX's for the nine
    rules × three cache dtypes × both layouts × two state dtypes (guards and
    resync on and off), and equal to what the port allocates
    (`Aggregator.nbytes` of the flat state, the tensors of the tree state
    and of the history ring).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AFLConfig as JAFLConfig  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import AFLConfig, ModelConfig  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core.aggregators import ALGORITHMS, Arrival  # noqa: E402
from repro_torch.core.distributed import (afl_state_bytes,  # noqa: E402
                                          history_ring_bytes, init_afl_state,
                                          make_afl_train_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

torch.set_num_threads(1)

RULES = ["ace", "ace_direct", "aced", "fedbuff", "ca2fl"]


def quad_loss(params, batch):
    return 0.5 * torch.sum((params["w"] - batch["c"]) ** 2) \
        + 0.5 * torch.sum((params["b"] - batch["c"][:2]) ** 2)


def jquad_loss(params, batch):
    return 0.5 * jnp.sum((params["w"] - batch["c"]) ** 2) \
        + 0.5 * jnp.sum((params["b"] - batch["c"][:2]) ** 2)


def _flat_agg_for(algo, tau_algo=3, M=2):
    return {"ace": lambda: tagg.ACEIncremental(),
            "ace_direct": lambda: tagg.ACEDirect(),
            "aced": lambda: tagg.ACED(tau_algo=tau_algo),
            "fedbuff": lambda: tagg.FedBuff(buffer_size=M),
            "ca2fl": lambda: tagg.CA2FL(buffer_size=M)}[algo]()


def _quad_params():
    return {"w": torch.zeros(6), "b": torch.zeros(2)}


def close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("algo", RULES)
def test_distributed_matches_flat(algo):
    """tests/test_distributed.py::test_distributed_matches_flat on the port:
    the train step over {w, b} against the flat rule on the raveled
    gradient (b first, then w)."""
    n, steps = 4, 10
    cfg = AFLConfig(algorithm=algo, n_clients=n, buffer_size=2, tau_algo=3)
    init_fn, step_fn = make_afl_train_step(quad_loss, cfg, sgd(0.1))
    state = init_fn(_quad_params())
    flat_agg = _flat_agg_for(algo)
    d = 8
    flat_state = flat_agg.init_state(n, d, torch.zeros((n, d)), "cpu")
    w_flat = torch.zeros(d)
    rng = np.random.default_rng(0)
    for t in range(steps):
        j = int(rng.integers(n))
        batch = {"c": torch.as_tensor(rng.normal(size=6), dtype=torch.float32)}
        state, _ = step_fn(state, batch, j, 1)
        ref = {"b": w_flat[:2].clone().requires_grad_(True),
               "w": w_flat[2:].clone().requires_grad_(True)}
        g = torch.autograd.grad(quad_loss(ref, batch), [ref["b"], ref["w"]])
        flat_state, u, sc = flat_agg.on_arrival(
            flat_state, Arrival(j, torch.cat(g), t, 1))
        if u is not None:
            w_flat = w_flat - 0.1 * sc * u
    got = torch.cat([state.params["b"], state.params["w"]])
    np.testing.assert_allclose(got.numpy(), w_flat.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_tree_cache_int8_invariant():
    n = 3
    grads_like = {"a": torch.zeros((4, 5)), "b": torch.zeros(7)}
    cache = tcache.init_tree_cache(n, grads_like, "int8", device="cpu")
    rng = np.random.default_rng(1)
    u = tcache.tree_cache_mean(cache)
    for _ in range(8):
        j = int(rng.integers(n))
        g = {"a": torch.as_tensor(rng.normal(size=(4, 5)) * 3,
                                  dtype=torch.float32),
             "b": torch.as_tensor(rng.normal(size=7), dtype=torch.float32)}
        old = tcache.cache_row(cache, j)
        cache = tcache.cache_set_row(cache, j, g)
        new = tcache.cache_row(cache, j)
        u = convert.tree_map(lambda u_, nw, od: u_ + (nw - od) / n, u, new,
                             old)
    mean = tcache.tree_cache_mean(cache)
    for a, b in zip(convert.leaves(u), convert.leaves(mean)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_int8_quantization_error_small_on_update_path():
    """ACE with an int8 cache tracks f32 ACE closely (paper Fig. a.3)."""
    n, steps = 4, 30
    traj = {}
    for cd in ("float32", "int8"):
        cfg = AFLConfig(algorithm="ace", n_clients=n, cache_dtype=cd)
        init_fn, step_fn = make_afl_train_step(quad_loss, cfg, sgd(0.1))
        state = init_fn(_quad_params())
        rng = np.random.default_rng(2)
        for t in range(steps):
            batch = {"c": torch.as_tensor(rng.normal(size=6),
                                          dtype=torch.float32)}
            state, _ = step_fn(state, batch, t % n, 1)
        traj[cd] = state.params["w"].numpy()
    err = np.linalg.norm(traj["int8"] - traj["float32"]) / \
        (np.linalg.norm(traj["float32"]) + 1e-9)
    assert err < 0.05


def test_afl_state_bytes_table():
    params = {"w": torch.zeros(1000)}
    base = AFLConfig(algorithm="ace", n_clients=8, cache_dtype="float32")
    assert afl_state_bytes(base, params) == 8 * 1000 * 4 + 8 * 4 + 4000
    q = AFLConfig(algorithm="ace", n_clients=8, cache_dtype="int8")
    assert afl_state_bytes(q, params) == 8 * 1000 + 8 * 4 + 4000
    fb = AFLConfig(algorithm="fedbuff", n_clients=8)
    assert afl_state_bytes(fb, params) == 4000 + 4
    asgd = AFLConfig(algorithm="asgd", n_clients=8)
    assert afl_state_bytes(asgd, params) == 0


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _jax_steps(loss_fn, jcfg, params, batches, clients, taus):
    init_fn, step_fn = jdist.make_afl_train_step(loss_fn, jcfg, jsgd(0.1))
    step_fn = jax.jit(step_fn)
    state, out = init_fn(params), []
    for b, j, tau in zip(batches, clients, taus):
        state, m = step_fn(state, b, jnp.int32(j), jnp.int32(tau))
        out.append((state, m))
    return out


def _port_steps(loss_fn, cfg, params, batches, clients, taus):
    init_fn, step_fn = make_afl_train_step(loss_fn, cfg, sgd(0.1))
    state, out = init_fn(params), []
    for b, j, tau in zip(batches, clients, taus):
        state, m = step_fn(state, b, torch.tensor(j, dtype=torch.int32),
                           torch.tensor(tau, dtype=torch.int32))
        # the rules write their caches in place: keep each step's copy
        out.append((convert.tree_map(lambda x: x.clone(), state.params),
                    convert.tree_map(lambda x: x.clone(), state.afl), m))
    return out


def _state_close(port_afl, jax_afl, tol=1e-5):
    assert sorted(port_afl) == sorted(jax_afl)
    for k in port_afl:
        a = (tcache.cache_tensors(port_afl[k]) if tcache.is_tree_cache(
            port_afl[k]) else convert.leaves(port_afl[k]))
        b = jax.tree.leaves(jax_afl[k])
        assert len(a) == len(b), k
        for x, y in zip(a, b):
            assert x.dtype == convert._tensor_from_numpy(np.asarray(y)).dtype
            close(x.float(), np.asarray(y, np.float32), tol)


@pytest.mark.parametrize("algo", RULES + ["delay_asgd"])
def test_train_step_matches_jax_on_the_quadratic(algo):
    n, steps = 4, 12
    rng = np.random.default_rng(5)
    cs = rng.normal(size=(steps, 6)).astype(np.float32)
    clients = rng.integers(n, size=steps).tolist()
    taus = rng.integers(0, 25, size=steps).tolist()
    kw = dict(algorithm=algo, n_clients=n, buffer_size=2, tau_algo=3)
    jout = _jax_steps(jquad_loss, JAFLConfig(**kw),
                      {"w": jnp.zeros(6), "b": jnp.zeros(2)},
                      [{"c": jnp.asarray(c)} for c in cs], clients, taus)
    tout = _port_steps(quad_loss, AFLConfig(**kw), _quad_params(),
                       [{"c": torch.as_tensor(c)} for c in cs], clients, taus)
    for (js, jm), (tp, tafl, tm) in zip(jout, tout):
        for k in ("b", "w"):
            close(tp[k], js.params[k])
        for k in ("loss", "grad_norm", "update_norm", "lr_scale"):
            assert tm[k].shape == () and tm[k].dtype == torch.float32
            close(tm[k], jm[k])
        _state_close(tafl, js.afl)
    assert int(jout[-1][0].step) == steps


CFG = jget_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)


def _lm_runs(algo, cache_dtype, steps=6, n=4):
    jmodel = jbuild(CFG)
    tmodel = build_model(ModelConfig(**dataclasses.asdict(CFG)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, CFG.vocab_size, size=(steps, 2, 33)).astype(
        np.int32)
    clients = [t % n for t in range(steps)]
    taus = rng.integers(0, 5, size=steps).tolist()
    kw = dict(algorithm=algo, n_clients=n, tau_algo=3,
              cache_dtype=cache_dtype)
    jout = _jax_steps(jmodel.loss_fn, JAFLConfig(**kw), jparams,
                      [{"tokens": jnp.asarray(x[:, :-1]),
                        "targets": jnp.asarray(x[:, 1:])} for x in toks],
                      clients, taus)
    tout = _port_steps(tmodel.loss_fn, AFLConfig(**kw), params,
                       [{"tokens": torch.as_tensor(x[:, :-1]),
                         "targets": torch.as_tensor(x[:, 1:])}
                        for x in toks], clients, taus)
    return jout, tout


@pytest.mark.parametrize("algo", ["ace", "aced"])
def test_train_step_matches_jax_on_the_lm_loss(algo):
    jout, tout = _lm_runs(algo, "float32")
    (js, jm), (tp, tafl, tm) = jout[-1], tout[-1]
    assert len(convert.leaves(tp)) == 11
    for a, b in zip(convert.leaves(tp), jax.tree.leaves(js.params)):
        close(a, b)
    _state_close(tafl, js.afl)
    for (_, jm_), (_, _, tm_) in zip(jout, tout):
        close(tm_["loss"], jm_["loss"])
        close(tm_["grad_norm"], jm_["grad_norm"], 1e-4)


def test_int8_train_step_matches_jax_to_a_code_step():
    jout, tout = _lm_runs("ace", "int8")
    (js, _), (tp, tafl, _) = jout[-1], tout[-1]
    off = total = 0
    for a, b in zip(tcache.cache_tensors(tafl["cache"]),
                    jax.tree.leaves(js.afl["cache"])):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.int8:
            step = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert step.max() <= 1
            off, total = off + int(step.sum()), total + step.size
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert off <= total * 1e-3, (off, total)
    for a, b in zip(convert.leaves(tp), jax.tree.leaves(js.params)):
        close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# byte counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_afl_state_bytes_match_jax_and_the_allocation(algo, cache_dtype,
                                                      state_dtype):
    n, d = 3, 37
    kw = dict(algorithm=algo, n_clients=n, cache_dtype=cache_dtype,
              state_dtype=state_dtype, buffer_size=2, tau_algo=4, k_batch=2)
    cfg, jcfg = AFLConfig(**kw), JAFLConfig(**kw)
    tree = {"a": torch.zeros((4, 6)), "b": torch.zeros(7)}
    jtree = {"a": jnp.zeros((4, 6)), "b": jnp.zeros(7)}
    for layout in ("flat", "tree"):
        for extra in ({}, {"guards": True, "resync_every": 4}):
            assert afl_state_bytes(cfg, tree, layout, **extra) == \
                jdist.afl_state_bytes(jcfg, jtree, layout, **extra)
    dtyped = cache_dtype == "float32" or algo in (
        "ace", "ace_direct", "aced", "aced_direct", "ca2fl", "ca2fl_direct")
    if not dtyped:
        return
    state = init_afl_state(cfg, tree)
    assert afl_state_bytes(cfg, tree, "tree") == sum(
        x.numel() * x.element_size() for v in state.values()
        for x in (tcache.cache_tensors(v) or convert.leaves(v)))
    if state_dtype == "float32":
        agg = tagg.make_aggregator(cfg)
        flat = agg.init_state(n, d, None, "cpu")
        assert afl_state_bytes(cfg, {"w": torch.zeros(d)}) == agg.nbytes(flat)


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16", "int8"])
def test_history_ring_bytes_match_jax_and_the_allocation(history_dtype):
    tree = {"a": torch.zeros((4, 6)), "b": torch.zeros(7)}
    jtree = {"a": jnp.zeros((4, 6)), "b": jnp.zeros(7)}
    for layout in ("flat", "tree"):
        assert history_ring_bytes(tree, 9, history_dtype, layout) == \
            jdist.history_ring_bytes(jtree, 9, history_dtype, layout)
    ring = tcache.init_tree_cache(10, tree, history_dtype, device="cpu")
    assert history_ring_bytes(tree, 9, history_dtype) == sum(
        x.numel() * x.element_size() for x in tcache.cache_tensors(ring))
    flat = tcache.init_tree_cache(10, torch.zeros(31), "float32",
                                  device="cpu")
    assert history_ring_bytes(tree, 9, layout="flat") == sum(
        x.numel() * x.element_size() for x in tcache.cache_tensors(flat))
