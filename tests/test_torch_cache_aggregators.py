"""The port's flat cache and its ACE / ACED / CA²FL rules against the JAX
package on identical inputs and arrival sequences: int8 (and bf16/f32)
cache rows and scales bit-identical, f32 running state and updates within
1e-5 (the repo's own contract between engines). Within the port, the fused
commit kernel's path agrees with the op chain within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(
        1.0, float(np.max(np.abs(b), initial=0.0)))


def _same_cache(tc, jc):
    assert np.array_equal(_np(tc.data), _np(jc.data))
    assert np.array_equal(_np(tc.scale), _np(jc.scale))


def _same_state(ts, js, tol=TOL):
    assert set(ts) == set(js)
    for k in ts:
        if isinstance(ts[k], tcache.FlatCache):
            _same_cache(ts[k], js[k])
        elif ts[k].dtype.is_floating_point:
            _close(ts[k], js[k], tol)
        else:
            assert np.array_equal(_np(ts[k]), _np(js[k])), k


# --- FlatCache ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_flat_cache_ops_match_jax(dtype):
    rng = np.random.default_rng(1)
    n, d = 6, 50
    init = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    tc = tcache.init_flat_cache(n, d, dtype, torch.as_tensor(init))
    jc = jcache.init_flat_cache(n, d, dtype, jnp.asarray(init))
    _same_cache(tc, jc)
    g = (rng.normal(size=d) * 5).astype(np.float32)
    tc.set_row(2, torch.as_tensor(g))
    jc = jc.set_row(2, jnp.asarray(g))
    _same_cache(tc, jc)
    _same = np.array_equal
    assert _same(_np(tc.row(2)), _np(jc.row(2)))
    g = (rng.normal(size=d) * 0.01).astype(np.float32)
    _, d1, o1 = tc.set_row_delta(4, torch.as_tensor(g))
    jc, d2, o2 = jc.set_row_delta(4, jnp.asarray(g))
    _same_cache(tc, jc)
    _close(d1, d2, 1e-6)
    assert _same(_np(o1), _np(o2))
    idx = np.array([5, 0, 3])
    G = (rng.normal(size=(3, d)) * 4).astype(np.float32)
    valid = np.array([True, False, True])
    G[~valid] = np.nan                      # an invalid lane is a no-op
    _, d1, o1 = tc.set_rows_delta(torch.as_tensor(idx), torch.as_tensor(G),
                                  torch.as_tensor(valid))
    jc, d2, o2 = jc.set_rows_delta(jnp.asarray(idx), jnp.asarray(G),
                                   jnp.asarray(valid))
    _same_cache(tc, jc)
    _close(d1, d2, 1e-6)
    assert _same(_np(o1), _np(o2))
    assert _same(_np(tc.rows(torch.as_tensor(idx))), _np(jc.rows(idx)))
    assert _same(_np(tc.dequant()), _np(jc.dequant()))
    mask = np.array([True, False, True, True, False, False])
    _close(tc.mean(), jc.mean(), 1e-6)
    _close(tc.mean(torch.as_tensor(mask)), jc.mean(jnp.asarray(mask)), 1e-6)
    _close(tcache.cache_sum(tc, torch.as_tensor(mask)),
           jcache.cache_sum(jc, jnp.asarray(mask)), 1e-6)
    assert tc.nbytes() == jc.nbytes()


@pytest.mark.parametrize("payload", ["random", "nan", "zero", "tiny"])
def test_fused_row_swap_plain_matches_jax(payload):
    """The plain version of the fused int8 row swap (`ops.row_delta`, CPU
    tensors, the row index a tensor on the cache's device) against JAX's
    `FlatCache.set_row_delta`: int8 rows and scales exact (a NaN payload
    gives a NaN scale and codes 0, a zero payload the scale 1e-12/127),
    delta and old within 1e-6, every other row untouched."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    n, d, j = 5, 70, 3
    init = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    tc = tcache.init_flat_cache(n, d, "int8", torch.as_tensor(init))
    jc = jcache.init_flat_cache(n, d, "int8", jnp.asarray(init))
    before = tc.data.clone(), tc.scale.clone()
    g = (rng.normal(size=d) * 3).astype(np.float32)
    if payload == "nan":
        g[[0, 41]] = np.nan
    elif payload == "zero":
        g[:] = 0.0
    elif payload == "tiny":
        g *= np.float32(1e-15)          # max|g| under the 1e-12 clamp
    idx = tcache.row_index(torch.tensor(j), tc.data.device)
    delta1, old1 = ops.row_delta(tc.data, tc.scale, idx, torch.as_tensor(g))
    jc, delta2, old2 = jc.set_row_delta(j, jnp.asarray(g))
    assert np.array_equal(_np(tc.data), _np(jc.data))
    np.testing.assert_array_equal(_np(tc.scale), _np(jc.scale))
    others = torch.arange(n) != j
    assert torch.equal(tc.data[others], before[0][others])
    assert torch.equal(tc.scale[others], before[1][others])
    _close(old1, old2, 1e-6)
    if payload == "nan":
        assert np.isnan(_np(tc.scale)[j]) and not _np(tc.data)[j].any()
        assert np.isnan(_np(delta1)).all() and np.isnan(_np(delta2)).all()
    else:
        _close(delta1, delta2, 1e-6)
    if payload in ("zero", "tiny"):
        assert _np(tc.scale)[j] == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_flat_commit_batch_matches_jax(dtype):
    rng = np.random.default_rng(2)
    n, d, K, R = 8, 40, 4, 2
    init = rng.normal(size=(n, d)).astype(np.float32)
    tc = tcache.init_flat_cache(n, d, dtype, torch.as_tensor(init))
    jc = jcache.init_flat_cache(n, d, dtype, jnp.asarray(init))
    idx = np.array([7, 1, 4, 2])
    valid = np.array([True, True, False, True])
    G = (rng.normal(size=(K, d)) * 3).astype(np.float32)
    G[~valid] = np.nan
    vecs = rng.normal(size=(R, d)).astype(np.float32)
    coef = rng.normal(size=(R, R + 4)).astype(np.float32)
    upd_w = rng.normal(size=(R + 4,)).astype(np.float32)
    la = (rng.random(K) * valid).astype(np.float32)
    args = [idx, G, valid, vecs, coef, upd_w]
    _, v1, u1 = tcache.flat_commit_batch(tc, *map(torch.as_tensor, args),
                                         lane_a=torch.as_tensor(la))
    jc, v2, u2 = jcache.flat_commit_batch(jc, *map(jnp.asarray, args),
                                          lane_a=jnp.asarray(la))
    _same_cache(tc, jc)
    _close(v1, v2, 1e-6)
    _close(u1, u2, 1e-6)


# --- the rules on identical arrival streams -----------------------------------

def _rules(name, dtype, K, fused=None):
    if name == "ace":
        return (tagg.ACEIncremental(cache_dtype=dtype, fused_commit=fused),
                jagg.ACEIncremental(cache_dtype=dtype))
    if name == "aced":
        mc = 1 if K == 1 else K
        return (tagg.ACED(tau_algo=3, cache_dtype=dtype, max_cohort=mc,
                          fused_commit=fused),
                jagg.ACED(tau_algo=3, cache_dtype=dtype, max_cohort=mc))
    return (tagg.CA2FL(buffer_size=3, cache_dtype=dtype, fused_commit=fused),
            jagg.CA2FL(buffer_size=3, cache_dtype=dtype))


def _stream(seed, T, n, d, K):
    """An arrival stream with strictly increasing t, one thaw jump (t
    leaps by 6 at tick 12) and, for K > 1, distinct clients per tick with
    some invalid (NaN-poisoned) lanes — among them an all-invalid tick."""
    rng = np.random.default_rng(seed)
    ts = np.arange(1, T + 1) + 5 * (np.arange(T) >= 12)
    clients = np.stack([rng.choice(n, size=K, replace=False)
                        for _ in range(T)])
    payloads = (rng.normal(size=(T, K, d)) * 3).astype(np.float32)
    valid = (rng.random((T, K)) < 0.8) | (K == 1)
    if K > 1:
        valid[7] = False
    payloads[~valid] = np.nan
    init = rng.normal(size=(n, d)).astype(np.float32)
    return ts, clients, payloads, valid, init


def _drive(agg, lib, stream, n, d, K):
    ts, clients, payloads, valid, init = stream
    arr = torch.as_tensor if lib == "torch" else jnp.asarray
    mod = tagg if lib == "torch" else jagg
    # the port's init_state takes the card unless told otherwise
    kw = {"device": "cpu"} if lib == "torch" else {}
    state = agg.init_state(n, d, arr(init) if getattr(agg, "cache_init",
                                                      False) else None, **kw)
    ups, emits = [], []
    for e in range(len(ts)):
        if K == 1:
            state, u, emit, _ = agg.step(state, mod.Arrival(
                int(clients[e, 0]), arr(payloads[e, 0]), int(ts[e]), 0))
        else:
            state, u, emit, _ = agg.step_batch(state, mod.ArrivalBatch(
                arr(clients[e]), arr(payloads[e]), int(ts[e]),
                arr(np.zeros(K, np.int32)), arr(valid[e])))
        ups.append(_np(u))
        emits.append(bool(emit))
    return state, np.stack(ups), np.array(emits)


CASES = [(name, dtype, K) for name in ("ace", "aced", "ca2fl")
         for dtype in ("int8", "float32") for K in (1, 4)]


@pytest.mark.parametrize("name,dtype,K", CASES)
def test_rule_matches_jax_on_one_stream(name, dtype, K):
    n, d, T = 8, 48, 24
    stream = _stream(3, T, n, d, K)
    t_agg, j_agg = _rules(name, dtype, K)
    ts_, tu, te = _drive(t_agg, "torch", stream, n, d, K)
    js_, ju, je = _drive(j_agg, "jax", stream, n, d, K)
    assert np.array_equal(te, je)
    _close(tu[te], ju[je])
    _same_state(ts_, {k: (v if isinstance(v, jcache.FlatCache) else v)
                      for k, v in js_.items()})


@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_fused_commit_matches_op_chain(name, dtype):
    """Within the port: the fused commit and the op chain write the same
    cache bit for bit and agree on state and updates within 1e-5."""
    n, d, T, K = 8, 48, 24, 4
    stream = _stream(4, T, n, d, K)
    sf, uf, ef = _drive(_rules(name, dtype, K, True)[0], "torch", stream, n,
                        d, K)
    sc, uc, ec = _drive(_rules(name, dtype, K, False)[0], "torch", stream, n,
                        d, K)
    assert np.array_equal(ef, ec)
    _close(uf[ef], uc[ec])
    for k in sf:
        if isinstance(sf[k], tcache.FlatCache):
            assert torch.equal(sf[k].data, sc[k].data)
            assert torch.equal(sf[k].scale, sc[k].scale)
        elif sf[k].dtype.is_floating_point:
            _close(sf[k], sc[k])
        else:
            assert torch.equal(sf[k], sc[k])


@pytest.mark.parametrize("K", [1, 4])
def test_aced_init_cohort_expiry_and_thaw_jump(K):
    """ACED's one-shot init-cohort expiry fires at t = τ+2 and a thaw jump
    retires several ring slots at once; the port's count and active sum
    track the JAX rule through both."""
    n, d, tau = 8, 16, 3
    rng = np.random.default_rng(5)
    init = rng.normal(size=(n, d)).astype(np.float32)
    t_agg = tagg.ACED(tau_algo=tau, max_cohort=max(1, K))
    j_agg = jagg.ACED(tau_algo=tau, max_cohort=max(1, K))
    ts_ = t_agg.init_state(n, d, torch.as_tensor(init))
    js_ = j_agg.init_state(n, d, jnp.asarray(init))
    counts = []
    # t = 1..6 crosses τ+2 = 5; then a jump to t = 14 (Δt = 8 > P = 5)
    for t in (1, 2, 3, 4, 5, 6, 14, 15):
        cl = rng.choice(n, size=K, replace=False)
        G = (rng.normal(size=(K, d))).astype(np.float32)
        if K == 1:
            ts_, tu, _, _ = t_agg.step(ts_, tagg.Arrival(
                int(cl[0]), torch.as_tensor(G[0]), t, 0))
            js_, ju, _, _ = j_agg.step(js_, jagg.Arrival(
                int(cl[0]), jnp.asarray(G[0]), t, 0))
        else:
            v = np.ones(K, bool)
            ts_, tu, _, _ = t_agg.step_batch(ts_, tagg.ArrivalBatch(
                torch.as_tensor(cl), torch.as_tensor(G), t,
                torch.zeros(K, dtype=torch.int32), torch.as_tensor(v)))
            js_, ju, _, _ = j_agg.step_batch(js_, jagg.ArrivalBatch(
                jnp.asarray(cl), jnp.asarray(G), t, jnp.zeros(K, jnp.int32),
                jnp.asarray(v)))
        _close(tu, ju)
        _same_state(ts_, dict(js_))
        counts.append(int(ts_["count"]))
    # before t = 5 the whole init cohort is active; at t = 5 it expires
    # except the clients that re-arrived since
    assert counts[0] == n
    assert counts[4] < n
    # after the jump only the cohort(s) of t = 14 and 15 are active
    assert counts[-1] <= 2 * K
    # and the running sum equals an exact recompute from the cache
    _close(ts_["asum"], t_agg.resync(ts_)["asum"])


def test_int8_cache_routes_quantizer_and_dequantizer_through_the_dispatch(
        monkeypatch):
    """`set_row`, the int8 init, `rows`, `dequant` and through it `mean` and
    `cache_sum` go through `kernels.ops.quantize_rows` / `dequantize_rows`
    (the kernels on a CUDA tensor), and pass ``backend`` on."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("quantize_rows", "dequantize_rows"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **k: (
            calls.append((_n, k.get("backend"))) or _r(*a, **k)))
    rng = np.random.default_rng(7)
    init = torch.as_tensor(rng.normal(size=(4, 10)).astype(np.float32))
    tc = tcache.init_flat_cache(4, 10, "int8", init, backend="torch")
    tc.set_row(1, torch.as_tensor(rng.normal(size=10).astype(np.float32)))
    tc.rows(torch.tensor([0, 2]))
    tc.mean()
    tcache.cache_sum(tc, torch.tensor([True, False, True, True]))
    assert calls == [("quantize_rows", "torch"), ("quantize_rows", None),
                     ("dequantize_rows", None), ("dequantize_rows", None),
                     ("dequantize_rows", None)]
    # a float cache quantizes nothing
    calls.clear()
    fc = tcache.init_flat_cache(4, 10, "float32", init)
    fc.set_row(1, init[0])
    fc.mean()
    assert calls == []
