"""The port's tree caches and the nine rules over parameter trees, against
the JAX package (the tree layout of `repro.core.cache` and
`repro.core.aggregators`).

  * Tree caches on a multi-leaf tree (a dict and a list, leaves of rank 1
    and 2) in f32, bf16 and int8: seeded and unseeded init, row reads,
    ``set_row``, ``set_row_delta``, ``set_rows_delta`` with invalid lanes
    (a NaN lane among them), masked mean and sum, nbytes. int8 codes and
    scales bit for bit, floats within 1e-6; the int8 ACE invariant of
    tests/test_distributed.py (``u == mean dq(C)``) on the port's cache.
  * Rules: every rule's ``step`` (and ``step_batch`` for the K > 1 rules)
    on a tree against the same rule on the raveled vectors (f32 caches,
    1e-5; emit and lr scale identical), and each rule's tree state against
    JAX's tree state after the same arrivals (1e-5, int8 rows and scales
    bit for bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs.base import AFLConfig  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402

torch.set_num_threads(1)

N = 5
# a dict holding a list: leaves of rank 2 and 1, raveled b, then w[0], w[1]
TEMPLATE = {"w": [np.zeros((3, 4), np.float32), np.zeros(6, np.float32)],
            "b": np.zeros(2, np.float32)}
D = 20


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return convert.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


def _draw(rng, lead=(), scale=1.0):
    """A tree like TEMPLATE with leading axes `lead`, per-leaf magnitudes
    spread over three decades so the int8 scales differ by leaf."""
    return convert.tree_map(
        lambda x: (rng.normal(size=lead + x.shape)
                   * scale * 10.0 ** rng.uniform(-1, 2)).astype(np.float32),
        TEMPLATE)


def _same(t, j, tol=1e-6):
    """A port structure against a JAX one, leaf for leaf in JAX's order:
    int8 and integer leaves exactly, floats within `tol` of the larger
    of 1 and the leaf's magnitude."""
    tl, jl = convert.leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        if not np.issubdtype(b.dtype, np.floating):
            assert np.array_equal(a, b)
        else:
            assert np.max(np.abs(a.astype(np.float64) - b), initial=0.0) \
                <= tol * max(1.0, float(np.max(np.abs(b), initial=0.0)))


def _same_cache(t, j):
    """Every code, scale and stored row bit for bit (leaf by leaf: q, then
    scale)."""
    tl, jl = tcache.cache_tensors(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert np.array_equal(_np(a), _np(b))


def _same_state(t, j, tol=1e-5):
    """A rule's tree state against JAX's: caches bit for bit, the rest by
    `_same`."""
    assert sorted(t) == sorted(j)
    for k in t:
        if tcache.is_tree_cache(t[k]):
            _same_cache(t[k], j[k])
        else:
            _same(t[k], j[k], tol)


# --- tree caches -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("seeded", [True, False])
def test_tree_cache_ops_match_jax(dtype, seeded):
    rng = np.random.default_rng(3)
    init = _draw(rng, (N,)) if seeded else None
    jc = jcache.init_tree_cache(N, _jtree(TEMPLATE), dtype,
                                _jtree(init) if seeded else None)
    tc = tcache.init_tree_cache(N, _ttree(TEMPLATE), dtype,
                                _ttree(init) if seeded else None,
                                device="cpu")
    assert tcache.is_tree_cache(tc)
    _same_cache(tc, jc)
    # the port's form of JAX's cache is the port's cache
    _same(convert.tree_cache_from_jax(jax.tree.map(np.asarray, jc)), jc)
    assert tcache.tree_cache_nbytes(tc) == jcache.tree_cache_nbytes(jc)
    assert tcache.cache_n(tc) == jcache.cache_n(jc) == N

    for step in range(6):
        i = int(rng.integers(N))
        g = _draw(rng)
        _same(tcache.cache_row(tc, i), jcache.cache_row(jc, i))
        if step % 2:
            tc2, td, to = tcache.cache_set_row_delta(tc, i, _ttree(g))
            jc, jd, jo = jcache.cache_set_row_delta(jc, i, _jtree(g))
            assert tc2 is tc                          # written in place
            _same(td, jd)
            _same(to, jo)
        else:
            assert tcache.cache_set_row(tc, i, _ttree(g)) is tc
            jc = jcache.cache_set_row(jc, i, _jtree(g))
        _same_cache(tc, jc)

    # K lanes, distinct rows, lane 1 invalid and carrying a NaN
    idx = np.array([4, 0, 2], np.int32)
    G = _draw(rng, (3,))
    G["w"][1][1, 2] = np.nan
    valid = np.array([True, False, True])
    before = [x.clone() for x in tcache.cache_tensors(tc)]
    _, td, to = tcache.cache_set_rows_delta(
        tc, torch.as_tensor(idx), _ttree(G), torch.as_tensor(valid))
    jc, jd, jo = jcache.cache_set_rows_delta(jc, jnp.asarray(idx), _jtree(G),
                                             jnp.asarray(valid))
    _same(td, jd)
    _same(to, jo)
    _same_cache(tc, jc)
    # the invalid lane's row and scale were written back bit-exactly
    for a, b in zip(tcache.cache_tensors(tc), before):
        assert torch.equal(a[0], b[0])
    _same(tcache.cache_rows(tc, torch.as_tensor(idx)),
          jcache.cache_rows(jc, jnp.asarray(idx)))

    mask = np.array([True, False, True, True, False])
    for m in (None, mask):
        tm = None if m is None else torch.as_tensor(m)
        jm = None if m is None else jnp.asarray(m)
        _same(tcache.cache_mean(tc, tm), jcache.cache_mean(jc, jm))
        _same(tcache.cache_sum(tc, tm), jcache.cache_sum(jc, jm))
    _same(tcache.cache_mean(tc, torch.zeros(N, dtype=torch.bool)),
          jcache.cache_mean(jc, jnp.zeros(N, bool)))


def test_tree_cache_int8_invariant():
    """tests/test_distributed.py's invariant on the port's int8 tree cache:
    a running mean kept as ``u += (dq(new) − dq(old))/n`` over row writes
    stays the mean of the dequantized rows."""
    n = 3
    like = {"a": torch.zeros((4, 5)), "b": torch.zeros(7)}
    cache = tcache.init_tree_cache(n, like, "int8", device="cpu")
    rng = np.random.default_rng(1)
    u = tcache.tree_cache_mean(cache)
    for _ in range(8):
        j = int(rng.integers(n))
        g = {"a": torch.as_tensor(rng.normal(size=(4, 5)) * 3,
                                  dtype=torch.float32),
             "b": torch.as_tensor(rng.normal(size=7), dtype=torch.float32)}
        _, delta, _ = tcache.tree_cache_set_row_delta(cache, j, g)
        u = convert.tree_map(lambda u_, d_: u_ + d_ / n, u, delta)
    mean = tcache.tree_cache_mean(cache)
    for a, b in zip(convert.leaves(u), convert.leaves(mean)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_tree_map_orders_like_jax():
    """`convert.tree_map` visits dicts by sorted key and lists in order,
    as JAX's flattening does, and rebuilds the structure."""
    tree = {"z": [1, 2], "a": {"y": 3, "b": 4}}
    seen = []
    out = convert.tree_map(lambda x: seen.append(x) or 10 * x, tree)
    assert seen == jax.tree.leaves(tree) == [4, 3, 1, 2]
    assert out == {"z": [10, 20], "a": {"y": 30, "b": 40}}
    assert convert.tree_map(lambda a, b: a + b, tree, out)["z"] == [11, 22]


# --- the nine rules over trees ----------------------------------------------

K_RULES = ("asgd", "delay_asgd", "fedbuff", "ca2fl", "ace", "aced")
DIRECT = ("ace_direct", "aced_direct", "ca2fl_direct")


def _rule(lib, name, dtype, K):
    cfg = AFLConfig(algorithm=name, n_clients=N, cache_dtype=dtype,
                    buffer_size=2, tau_algo=2, k_batch=K,
                    max_delay_scale=0.4, delay_beta=5.0)
    return (tagg if lib == "torch" else jagg).make_aggregator(cfg)


def _arrivals(seed, K, steps=9):
    """(clients, payloads (K, D) per tick, t, staleness, valid) of a
    stream with a jump in t (an expiry sweep for ACED) and, at K > 1, an
    invalid NaN lane now and then."""
    rng = np.random.default_rng(seed)
    out, t = [], 1
    for s in range(steps):
        js = rng.choice(N, size=K, replace=False).astype(np.int32)
        G = (rng.normal(size=(K, D)) * rng.uniform(0.5, 5)).astype(np.float32)
        valid = np.ones(K, bool)
        if K > 1 and s % 3 == 1:
            valid[1] = False
            G[1, 3] = np.nan
        out.append((js, G, t, rng.integers(0, 6, size=K).astype(np.int32),
                    valid))
        t += 3 if s == 4 else 1
    return out


def _unravel_lanes(G):
    """(K, D) rows as a TEMPLATE-like tree whose leaves lead with (K,)."""
    _, unravel = ravel_pytree(_jtree(TEMPLATE))
    per = [jax.tree.map(np.asarray, unravel(jnp.asarray(g))) for g in G]
    return jax.tree.map(lambda *xs: np.stack(xs), *per)


def _run_rule(agg, lib, tree, dtype, K, seed, init):
    """Feed one rule the stream of `_arrivals` -> (state, [(update, emit,
    lr_scale)])."""
    def arr(x):
        if lib == "torch":
            return _ttree(x) if tree else torch.as_tensor(x)
        return _jtree(x) if tree else jnp.asarray(x)

    tpl = (_ttree(TEMPLATE) if lib == "torch" else _jtree(TEMPLATE)) \
        if tree else D
    rows = _unravel_lanes(init) if tree else init
    kw = {"device": "cpu"} if lib == "torch" else {}
    seeds = arr(rows) if jagg.wants_cache_init(agg) else None
    state = agg.init_state(N, tpl, seeds, **kw)
    mods = (tagg, torch.as_tensor) if lib == "torch" else (jagg, jnp.asarray)
    outs = []
    for js, G, t, tau, valid in _arrivals(seed, K):
        P = _unravel_lanes(G) if tree else G
        if K == 1:
            one = jax.tree.map(lambda x: x[0], P)
            state, u, emit, sc = agg.step(state, mods[0].Arrival(
                int(js[0]), arr(one), t, int(tau[0])))
        else:
            state, u, emit, sc = agg.step_batch(state, mods[0].ArrivalBatch(
                mods[1](js), arr(P), t, mods[1](tau), mods[1](valid)))
        outs.append((u, bool(emit), float(sc)))
    return state, outs


def _rule_cases():
    cases = [(r, dt, K) for r in K_RULES for dt in ("float32", "int8")
             for K in (1, 3) if not (r in ("asgd", "delay_asgd", "fedbuff")
                                     and dt == "int8")]
    return cases + [(r, dt, 1) for r in DIRECT for dt in ("float32", "int8")]


def _ravel(u):
    if isinstance(u, torch.Tensor):
        return u.numpy()
    return convert.ravel(u).numpy()


@pytest.mark.parametrize("name,dtype,K", _rule_cases())
def test_rule_tree_matches_flat_and_jax(name, dtype, K):
    init = np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)
    t_state, t_out = _run_rule(_rule("torch", name, dtype, K), "torch", True,
                               dtype, K, 11, init)
    j_state, j_out = _run_rule(_rule("jax", name, dtype, K), "jax", True,
                               dtype, K, 11, init)
    # the port's tree state is JAX's: int8 rows and scales bit for bit
    if not isinstance(j_state, tuple):
        _same_state(t_state, j_state)
    for (tu, te, ts), (ju, je, js) in zip(t_out, j_out):
        assert te == je and ts == pytest.approx(js, rel=1e-6)
        if te:
            _same(tu, ju, 1e-5)
    if dtype == "int8":
        return      # int8 quantizes per leaf on a tree, per row when flat
    f_state, f_out = _run_rule(_rule("torch", name, dtype, K), "torch",
                               False, dtype, K, 11, init)
    for (tu, te, ts), (fu, fe, fs) in zip(t_out, f_out):
        assert te == fe and ts == fs
        if te:
            np.testing.assert_allclose(_ravel(tu), _ravel(fu), rtol=1e-5,
                                       atol=1e-5)
    agg = _rule("torch", name, dtype, K)
    assert agg.nbytes(t_state) == agg.nbytes(f_state) \
        - (N * 4 if tcache.FlatCache in map(type, f_state.values()) else 0)


def test_tree_rule_returns_its_cache_in_place():
    """A tree rule writes its cache in place and hands the same object
    back, as the engine's copy-back needs."""
    agg = tagg.ACED(tau_algo=2, cache_dtype="int8")
    init = _ttree(_draw(np.random.default_rng(0), (N,)))
    state = agg.init_state(N, _ttree(TEMPLATE), init, device="cpu")
    cache = state["cache"]
    state, _, _, _ = agg.step(state, tagg.Arrival(
        1, _ttree(_draw(np.random.default_rng(1))), 1, 0))
    assert state["cache"] is cache
    assert agg.resync(state)["cache"] is cache
