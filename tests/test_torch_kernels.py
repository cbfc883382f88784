"""The port's kernels against the JAX package: each plain PyTorch version
(`repro_torch.kernels.ref`) against `repro.kernels.ref` and against the
Pallas kernel in interpret mode, on the same numpy inputs. int8 rows must be
bit-identical; f32 outputs agree within 1e-6 (relative to the output's
scale: the only differences are the order of f32 sums). The CUDA kernels
against their plain versions on the card are in test_torch_cuda.py."""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cache_update import cache_row_update as pallas_cru  # noqa: E402
from repro.kernels.commit_batch import commit_batch as pallas_cb  # noqa: E402
from repro.kernels.row_delta import row_delta as pallas_rd  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import scan_staleness  # noqa: E402
from repro_torch.kernels import backend, build, ops  # noqa: E402
from repro_torch.kernels import cache_update as _cu  # noqa: E402
from repro_torch.kernels import commit_batch as _cb  # noqa: E402
from repro_torch.kernels import masked_agg as _ma  # noqa: E402
from repro_torch.kernels import quant as _q  # noqa: E402
from repro_torch.kernels import row_delta as _rd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_TOL = 1e-6


def _t(x, device="cpu"):
    return None if x is None else torch.as_tensor(np.array(x)).to(device)


def _close(a, b, tol=F32_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    assert np.max(np.abs(a - b), initial=0.0) <= tol * scale


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def row_inputs(seed, d):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d).astype(np.float32)
    g = (rng.normal(size=d) * 5).astype(np.float32)
    # with max|g| = 127 the new scale is 1.0, so these are exact .5 ties of
    # g / new_scale: they exercise round-half-to-even
    g[: min(d, 5)] = np.float32([127.0, 2.5, -0.5, 1.5, 3.5])[: min(d, 5)]
    q, s = jref.quantize_rows_ref(jnp.asarray(rng.normal(size=(1, d)),
                                              jnp.float32))
    return dict(u=u, g=g, crow=np.asarray(q[0]), osc=np.float32(s[0]),
                nsc=np.float32(jref.row_scale(jnp.asarray(g))))


@pytest.mark.parametrize("d", [1, 129, 300])
def test_row_scale_and_quantize_match_jax(d):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(5, d)) * rng.uniform(0.1, 50, size=(5, 1))
         ).astype(np.float32)
    x[0] = 0.0                              # the 1e-12 scale clamp
    _same(tref.row_scale(_t(x)).numpy(), jref.row_scale(jnp.asarray(x)))
    q1, s1 = tref.quantize_rows_ref(_t(x))
    q2, s2 = jref.quantize_rows_ref(jnp.asarray(x))
    _same(q1.numpy(), q2)
    _same(s1.numpy(), s2)
    _same(tref.dequantize_rows_ref(q1, s1).numpy(),
          jref.dequantize_rows_ref(q2, s2))


@pytest.mark.parametrize("d", [1, 129, 300])
def test_masked_agg_matches_jax(d):
    rng = np.random.default_rng(d + 1)
    q, s = jref.quantize_rows_ref(jnp.asarray(rng.normal(size=(6, d)),
                                              jnp.float32))
    for mask in (rng.random(6) < 0.5, np.zeros(6, bool)):
        _close(tref.masked_agg_ref(_t(q), _t(s), _t(mask)).numpy(),
               jref.masked_agg_ref(q, s, jnp.asarray(mask)))


@pytest.mark.parametrize("d,blk", [(1, 128), (129, 128), (300, 2048)])
def test_cache_row_update_plain_matches_jax(d, blk):
    x = row_inputs(2 + d, d)
    inv_n = np.float32(0.125)
    u1, c1 = tref.cache_row_update_ref(_t(x["u"]), _t(x["g"]), _t(x["crow"]),
                                       _t(x["osc"]), _t(x["nsc"]), _t(inv_n))
    args = (jnp.asarray(x["u"]), jnp.asarray(x["g"]), jnp.asarray(x["crow"]),
            x["osc"], x["nsc"], inv_n)
    u2, c2 = jref.cache_row_update_ref(*args)
    u3, c3 = pallas_cru(*args, interpret=True, block_d=blk)
    _same(c1.numpy(), c2)
    _same(c1.numpy(), c3)
    _close(u1.numpy(), u2)
    _close(u1.numpy(), u3)


@pytest.mark.parametrize("d,blk", [(1, 128), (129, 128), (300, 2048)])
def test_row_delta_plain_matches_jax(d, blk):
    x = row_inputs(4 + d, d)
    d1, c1 = tref.row_delta_ref(_t(x["g"]), _t(x["crow"]), _t(x["osc"]),
                                _t(x["nsc"]))
    args = (jnp.asarray(x["g"]), jnp.asarray(x["crow"]), x["osc"], x["nsc"])
    d2, c2 = jref.row_delta_ref(*args)
    d3, c3 = pallas_rd(*args, interpret=True, block_d=blk)
    _same(c1.numpy(), c2)
    _same(c1.numpy(), c3)
    _close(d1.numpy(), d2)
    _close(d1.numpy(), d3)


# --- the whole int8 ACE step (`ops.cache_row_update`) ------------------------

ACE_ROWS = [0, 4, 2, 0, 4, 1]       # j = 0 and j = n − 1 of 5 rows, twice
BF16_ULP = 2.0 ** -8                # bfloat16's spacing relative to |x|


def ace_cache(seed, n, d, state):
    """An int8 cache of n rows, a state u of `state`'s dtype and the
    arrivals' payloads (their scales 1e-2 to 10), as numpy."""
    rng = np.random.default_rng(seed)
    q, s = jref.quantize_rows_ref(jnp.asarray(
        (rng.normal(size=(n, d)) * 2).astype(np.float32)))
    u = rng.normal(size=d).astype(np.float32)
    g = [(rng.normal(size=d) * 10.0 ** (a % 4 - 2)).astype(np.float32)
         for a in range(len(ACE_ROWS))]
    return np.array(q), np.array(s), u, g


@pytest.mark.parametrize("route", ["xla", "interpret"])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 7, 300, 1030])
def test_whole_ace_step_plain_matches_jax(d, state, route, monkeypatch):
    """The plain whole call (`ops.cache_row_update` on CPU tensors,
    `ref.set_row_ace_ref`) against JAX's `ACEIncremental.step` on a flat
    int8 cache, six arrivals in a row on rows 0, n − 1 and between, with
    the step's `cache_row_update` taken through the JAX package's XLA
    oracle or run as the Pallas kernel in the interpreter. Rows and scales
    bit for bit on both routes. u (JAX's f32 u cast back to the state
    dtype, as `test_state_dtype_repair` does): bit for bit on the oracle
    route; on the interpreter route XLA fuses the kernel body and rounds
    the f32 sums otherwise in the last bit, so f32 within 1e-6 relative and
    bf16 within one bf16 ulp. u' is a fresh tensor; the input u and every
    other row are left as they were."""
    monkeypatch.setattr(jops, "cache_row_update", functools.partial(
        jops.cache_row_update, backend=route))
    n = 5
    q, s, u0, gs = ace_cache(d + 17, n, d, state)
    jdt, tdt = (jnp.float32, torch.float32) if state == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    agg = jagg.ACEIncremental(cache_dtype="int8", state_dtype=state)
    jst = {"cache": jcache.FlatCache(jnp.asarray(q), jnp.asarray(s)),
           "u": jnp.asarray(u0).astype(jdt)}
    data, scale = torch.as_tensor(q.copy()), torch.as_tensor(s.copy())
    u = torch.as_tensor(u0).to(tdt)
    for a, (j, g) in enumerate(zip(ACE_ROWS, gs)):
        rows0, scale0, u_in, u_prev = data.clone(), scale.clone(), \
            u.clone(), u
        u = ops.cache_row_update(data, scale, torch.tensor([j]),
                                 torch.as_tensor(g), u, 1.0 / n)
        jst, ju, _, _ = agg.step(jst, jagg.Arrival(j, jnp.asarray(g), a, 0))
        jst = {**jst, "u": ju.astype(jdt)}
        assert torch.equal(u_prev, u_in) and u.dtype == tdt
        assert u.data_ptr() != u_prev.data_ptr()
        others = torch.arange(n) != j
        assert torch.equal(data[others], rows0[others])
        assert torch.equal(scale[others], scale0[others])
        _same(data.numpy(), np.asarray(jst["cache"].data))
        _same(scale.numpy(), np.asarray(jst["cache"].scale))
        a32 = u.float().numpy()
        b32 = np.asarray(jst["u"].astype(jnp.float32))
        if route == "xla":
            _same(a32, b32)
        elif state == "float32":
            _close(a32, b32)
        else:
            assert np.all(np.abs(a32 - b32) <= BF16_ULP * np.abs(b32))


def _quant_multiply(g, s):
    """numpy float32 copy of `quant_fast` in kernels/csrc/common.cuh, the
    CUDA kernels' int8 rounding by one multiply: (codes, decided). Where
    `decided` is false the kernel divides instead."""
    with np.errstate(divide="ignore", over="ignore"):
        inv = np.float32(1.0) / s
    inv = np.where(np.isfinite(inv), inv, np.float32(np.nan))
    q0 = g * inv
    n = np.rint(q0)
    margin = np.float32(0.5) - np.float32(1e-4)
    with np.errstate(invalid="ignore"):
        decided = (np.abs(q0) >= 129) | (np.abs(q0 - n) < margin)
    return np.clip(n, -127, 127), decided


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_multiply_shortcut_matches_division(seed):
    """Wherever the kernels' multiply decides an int8 code, the code is the
    one the JAX reference's division gives: on random payloads and scales
    from 1e-8 to 1e2 (the multiply decides nearly all of them), on a
    subnormal scale whose reciprocal overflows, and on payloads placed on
    half-way ties and a few ulps to 2e-4 off them (it must leave those
    within 1e-4 of a tie to the division)."""
    rng = np.random.default_rng(seed)
    rows, d = 48, 4096
    s = np.float32(10.0 ** rng.uniform(-8, 2, size=(rows, 1)))
    s[::3] = np.float32(2.0 ** -rng.integers(3, 12, size=(len(s[::3]), 1)))
    q_true = rng.uniform(-200, 200, size=(rows, d))
    ties = np.floor(q_true[: rows // 2]) + 0.5 + rng.choice(
        [0.0, 2.0 ** -20, -2.0 ** -20, 1e-5, -1e-5, 9e-5, -9e-5, 1.1e-4,
         -1.1e-4, 2e-4, -2e-4], size=(rows // 2, d))
    q_true[: rows // 2] = ties
    s[rows - 2] = np.float32(1e-40)       # 1 / s overflows: all divide
    g = np.float32(q_true * s)
    g[rows - 1, :4] = [0.0, -0.0, np.inf, -np.inf]
    q_div = np.clip(np.rint(g / s), -127, 127)
    q_mul, decided = _quant_multiply(g, s)
    assert np.array_equal(q_mul[decided], q_div[decided])
    assert decided[rows // 2:rows - 2].mean() > 0.99
    assert not decided[rows - 2].any()
    assert not decided[: rows // 2].all()
    for r in (0, rows // 2, rows - 1):     # the division is JAX's
        _, c = jref.row_delta_ref(jnp.asarray(g[r]), jnp.zeros(d, jnp.int8),
                                  np.float32(1.0), s[r, 0])
        _same(np.asarray(c), q_div[r].astype(np.int8))


# --- NaN and ±inf payloads: the int8 codes and scales of the JAX package ------
# A row holding a NaN gets a NaN scale, a row holding ±inf an inf scale; in
# both every code is 0 (XLA converts a NaN quotient to 0, and x/inf is 0).
# The port's plain versions must give the same codes, and the CUDA kernels
# follow them (test_torch_cuda.py).

SPECIAL = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}
QUANTIZERS = ["quantize_rows", "row_delta", "cache_row_update",
              "commit_batch", "set_row_ace"]


def special_rows(kind, d=40):
    """(3, d) f32: row 0 holds `kind` at two places, rows 1-2 are finite."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, d)) * 3).astype(np.float32)
    x[0, [1, d - 2]] = SPECIAL[kind]
    return x


@pytest.mark.parametrize("fn", QUANTIZERS)
@pytest.mark.parametrize("kind", sorted(SPECIAL))
def test_nan_and_inf_rows_take_jax_codes(kind, fn):
    x = special_rows(kind)
    d = x.shape[1]
    if fn == "quantize_rows":
        q1, s1 = tref.quantize_rows_ref(_t(x))
        q2, s2 = jref.quantize_rows_ref(jnp.asarray(x))
        np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
        assert np.isnan(s2[0]) if kind == "nan" else np.isinf(s2[0])
    elif fn in ("row_delta", "cache_row_update"):
        c = np.asarray(jref.quantize_rows_ref(jnp.asarray(x[1:2]))[0][0])
        osc, nsc = np.float32(0.25), np.float32(jref.row_scale(x[0]))
        if fn == "row_delta":
            _, q1 = tref.row_delta_ref(_t(x[0]), _t(c), _t(osc), _t(nsc))
            _, q2 = jref.row_delta_ref(jnp.asarray(x[0]), jnp.asarray(c),
                                       osc, nsc)
        else:
            u = np.ones(d, np.float32)
            _, q1 = tref.cache_row_update_ref(_t(u), _t(x[0]), _t(c),
                                              _t(osc), _t(nsc),
                                              _t(np.float32(0.5)))
            _, q2 = jref.cache_row_update_ref(
                jnp.asarray(u), jnp.asarray(x[0]), jnp.asarray(c), osc, nsc,
                np.float32(0.5))
        q1, q2 = q1[None], np.asarray(q2)[None]
    elif fn == "set_row_ace":
        # the whole ACE step on row 0 of a 3-row cache, against JAX's step
        q, s = jref.quantize_rows_ref(jnp.asarray(x[[1, 2, 1]]))
        data, scale = torch.as_tensor(np.array(q)), torch.as_tensor(
            np.array(s))
        u = np.ones(d, np.float32)
        ops.cache_row_update(data, scale, torch.tensor([0]), _t(x[0]),
                             _t(u), 1.0 / 3)
        jst, _, _, _ = jagg.ACEIncremental(cache_dtype="int8").step(
            {"cache": jcache.FlatCache(q, s), "u": jnp.asarray(u)},
            jagg.Arrival(0, jnp.asarray(x[0]), 0, 0))
        np.testing.assert_array_equal(scale.numpy(),
                                      np.asarray(jst["cache"].scale))
        q1, q2 = data, np.asarray(jst["cache"].data)
    else:
        kw = commit_inputs(5, 3, d, 1, "int8", (), valid=np.ones(3, bool))
        kw["G"] = x
        kw["new_s"] = np.asarray(jref.row_scale(jnp.asarray(x)))
        q1, _, _ = tref.commit_batch_ref(**_torch_kw(kw))
        q2, _, _ = jref.commit_batch_ref(**_jax_kw(kw))
    _same(q1.numpy(), np.asarray(q2))
    assert not q1.numpy()[0].any()           # every code of the row is 0


def commit_inputs(seed, K, d, R, row_dtype, lanes, valid=None, nan=False):
    """Random inputs in the aggregator calling convention: lane weights are
    zero on invalid lanes and `new_s` scales the sanitized payloads, as
    `flat_commit_batch` prepares them. ``nan`` poisons the invalid lanes'
    payloads."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=(K, d)) * 3).astype(np.float32)
    if valid is None:
        valid = rng.random(K) < 0.7
    valid = np.asarray(valid, bool)
    if nan:
        G[~valid] = np.nan
    rows_f = rng.normal(size=(K, d)).astype(np.float32)
    kw = dict(G=G, valid=valid,
              vecs=rng.normal(size=(R, d)).astype(np.float32),
              coef=rng.normal(size=(R, R + 4)).astype(np.float32),
              upd_w=rng.normal(size=(R + 4,)).astype(np.float32))
    if row_dtype == "int8":
        q, s = jref.quantize_rows_ref(jnp.asarray(rows_f))
        kw.update(old_rows=np.asarray(q), old_s=np.asarray(s),
                  new_s=np.asarray(jref.row_scale(
                      jnp.where(valid[:, None], G, 0.0))))
    else:
        kw.update(old_rows=np.asarray(jnp.asarray(rows_f, row_dtype)),
                  old_s=None, new_s=None)
    for name in lanes:
        kw[f"lane_{name}"] = (rng.random(K) * valid).astype(np.float32)
    return kw


def _torch_kw(kw, device="cpu"):
    out = {}
    for k, v in kw.items():
        if v is not None and np.asarray(v).dtype == jnp.bfloat16:
            out[k] = _t(np.asarray(v, np.float32), device).to(torch.bfloat16)
        else:
            out[k] = _t(v, device)
    return out


def _jax_kw(kw):
    return {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}


def _rows_np(rows):
    return (rows.float() if rows.dtype == torch.bfloat16 else rows).numpy()


def _jrows_np(rows):
    rows = np.asarray(rows)
    return rows.astype(np.float32) if rows.dtype == jnp.bfloat16 else rows


COMMIT_CASES = [
    # K, d, R, rows, lanes, block_d of the Pallas run
    (1, 257, 1, "int8", (), 128),               # ACE shape, ragged tile
    (4, 300, 2, "int8", ("a", "b"), 2048),      # ACED shape
    (3, 129, 3, "int8", ("a", "g"), 128),       # CA²FL shape
    (4, 200, 3, "float32", ("a", "b", "g"), 128),
    (2, 150, 2, "bfloat16", ("a",), 128),
]


@pytest.mark.parametrize("K,d,R,rows,lanes,blk", COMMIT_CASES)
def test_commit_batch_plain_matches_jax(K, d, R, rows, lanes, blk):
    kw = commit_inputs(7 * K + d, K, d, R, rows, lanes)
    r1, v1, u1 = tref.commit_batch_ref(**_torch_kw(kw))
    r2, v2, u2 = jref.commit_batch_ref(**_jax_kw(kw))
    _same(_rows_np(r1), _jrows_np(r2))
    _close(v1.numpy(), v2)
    _close(u1.numpy(), u2)
    if rows != "bfloat16":    # the Pallas kernel's interpreter: f32/int8
        r3, v3, u3 = pallas_cb(**_jax_kw(kw), block_d=blk, interpret=True)
        _same(_rows_np(r1), _jrows_np(r3))
        _close(v1.numpy(), v3)
        _close(u1.numpy(), u3)


@pytest.mark.parametrize("rows", ["int8", "float32"])
def test_commit_batch_nan_poisoned_invalid_lanes(rows):
    """A NaN payload on an invalid lane leaves its row bit-exact and every
    sum finite, as in the JAX package."""
    valid = np.array([True, False, True, False])
    kw = commit_inputs(11, 4, 300, 2, rows, ("a", "g"), valid=valid, nan=True)
    r1, v1, u1 = tref.commit_batch_ref(**_torch_kw(kw))
    assert np.array_equal(r1.numpy()[~valid], kw["old_rows"][~valid])
    assert np.isfinite(v1.numpy()).all() and np.isfinite(u1.numpy()).all()
    for r2, v2, u2 in (jref.commit_batch_ref(**_jax_kw(kw)),
                       pallas_cb(**_jax_kw(kw), block_d=128, interpret=True)):
        _same(r1.numpy(), r2)
        _close(v1.numpy(), v2)
        _close(u1.numpy(), u2)


def test_commit_batch_all_masked_batch():
    """An all-invalid batch keeps every row and reduces the output to the
    affine recombination of the running-sum vectors."""
    kw = commit_inputs(13, 4, 200, 2, "int8", ("a", "b"),
                       valid=np.zeros(4, bool), nan=True)
    r1, v1, u1 = tref.commit_batch_ref(**_torch_kw(kw))
    _same(r1.numpy(), kw["old_rows"])
    _close(v1.numpy(), kw["coef"][:, :2] @ kw["vecs"])
    for r2, v2, u2 in (jref.commit_batch_ref(**_jax_kw(kw)),
                       pallas_cb(**_jax_kw(kw), block_d=128, interpret=True)):
        _same(r1.numpy(), r2)
        _close(v1.numpy(), v2)
        _close(u1.numpy(), u2)


# --- masked_agg, quantize_rows, dequantize_rows -------------------------------
# The port's dispatch on CPU tensors (the plain versions) against the JAX
# package's dispatch with backend="interpret" (the Pallas bodies run by the
# interpreter) and backend="xla" (its oracles), at odd widths.

JAX_BACKENDS = ["interpret", "xla"]
ODD_D = [1, 129, 2051]
# with max|x| = 127 a row's scale is exactly 1.0, so these are .5 ties of
# x / scale: round half to even gives 2, -0, 2, 4, -2, 0, -126
TIES = np.float32([127.0, 2.5, -0.5, 1.5, 3.5, -2.5, 0.5, -126.5])


def quant_rows(seed, d, n=5):
    """Rows of mixed magnitudes, one all-zero row (the 1e-12 scale clamp)
    and one row of half-way ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * rng.uniform(0.1, 50, size=(n, 1))
         ).astype(np.float32)
    x[1] = 0.0
    x[2] = np.resize(TIES, d)
    return x


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("d", ODD_D)
def test_quantize_rows_plain_matches_jax(d, backend):
    """q bit-identical to both JAX routes. The scale is the oracle's true
    division ``max(max|x|, 1e-12) / 127``, bit for bit; the Pallas wrapper
    is jitted, and XLA compiles its division by the constant 127 into a
    multiply by the f32 reciprocal, which is that product bit for bit."""
    x = quant_rows(d, d)
    q1, s1 = ops.quantize_rows(_t(x))
    q2, s2 = jops.quantize_rows(jnp.asarray(x), backend=backend)
    _same(q1.numpy(), q2)
    m = np.maximum(np.abs(x).max(1), np.float32(1e-12))
    _same(s1.numpy(), m / np.float32(127.0))
    if backend == "xla":
        _same(s1.numpy(), s2)
    else:
        _same(np.asarray(s2), m * (np.float32(1.0) / np.float32(127.0)))
        assert np.all(np.abs(s1.numpy() - s2) <= np.spacing(s2))
    assert float(s1[1]) == np.float32(1e-12) / np.float32(127.0)
    assert not q1[1].any()
    expect = np.int8([127, 2, 0, 2, 4, -2, 0, -126])[:d]
    assert np.array_equal(q1[2, :8].numpy(), expect)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("d", ODD_D)
def test_dequantize_rows_plain_matches_jax(d, backend):
    q, s = jref.quantize_rows_ref(jnp.asarray(quant_rows(d + 3, d)))
    x1 = ops.dequantize_rows(_t(q), _t(s))
    x2 = jops.dequantize_rows(q, s, backend=backend)
    _same(x1.numpy(), x2)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("d", ODD_D)
def test_masked_agg_plain_matches_jax_kernel(d, backend):
    n = 7
    rng = np.random.default_rng(d + 11)
    q, s = jref.quantize_rows_ref(jnp.asarray(quant_rows(d + 5, d, n)))
    for mask in (rng.random(n) < 0.5, np.zeros(n, bool), np.ones(n, bool)):
        u1 = ops.masked_agg(_t(q), _t(s), _t(mask))
        u2 = jops.masked_agg(q, s, jnp.asarray(mask), backend=backend)
        assert u1.dtype == torch.float32 and u1.shape == (d,)
        _close(u1.numpy(), u2)
        if not mask.any():
            assert not u1.any()


def test_masked_agg_plain_sums_rows_in_order():
    """The plain version forms ``w = m·s / max(Σm, 1)`` and adds the rows
    0..n−1 one after another — the CUDA kernel's order, so the two agree
    bit for bit on the card."""
    q, s = tref.quantize_rows_ref(torch.as_tensor(quant_rows(4, 300, 6)))
    mask = torch.tensor([True, False, True, True, False, True])
    w = mask.float() * s / mask.float().sum()
    acc = torch.zeros(300)
    for i in range(6):
        acc = acc + w[i] * q[i].float()
    assert torch.equal(tref.masked_agg_ref(q, s, mask), acc)


# --- dispatch and device policy ---------------------------------------------

def swap_inputs(seed, n, d):
    """An int8 cache (data, scale), a row index as a one-element int64
    tensor and a payload, for the fused row swap (`ops.row_delta`)."""
    rng = np.random.default_rng(seed)
    q, s = tref.quantize_rows_ref(_t(rng.normal(size=(n, d)).astype(
        np.float32)))
    g = _t((rng.normal(size=d) * 5).astype(np.float32))
    return q, s, torch.tensor([n // 2]), g


def test_cpu_tensors_take_the_plain_version():
    data, scale, j, g = swap_inputs(5, 6, 64)
    d2, c2 = data.clone(), scale.clone()
    before = ops.launch_counts()
    delta1, old1 = ops.row_delta(data, scale, j, g)
    delta2, old2 = ops.row_delta(d2, c2, j, g, backend="torch")
    assert torch.equal(delta1, delta2) and torch.equal(old1, old2)
    assert torch.equal(data, d2) and torch.equal(scale, c2)
    assert ops.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel modules' wrappers launch on CUDA tensors only: a CPU
    tensor raises there instead of running anything."""
    x = row_inputs(6, 64)
    with pytest.raises(TypeError, match="CUDA tensor"):
        _rd.row_delta(*swap_inputs(6, 4, 64))
    with pytest.raises(TypeError, match="CUDA tensor"):
        _cu.cache_row_update(*swap_inputs(6, 4, 64), _t(x["u"]), 0.5)
    kw = _torch_kw(commit_inputs(3, 2, 32, 1, "int8", ()))
    with pytest.raises(TypeError, match="CUDA tensor"):
        _cb.commit_batch(**kw)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.commit_batch(**kw, backend="cuda")


def test_fused_commit_env_switch(monkeypatch):
    monkeypatch.delenv("REPRO_NO_FUSED_COMMIT", raising=False)
    assert backend.fused_commit_enabled() is True
    monkeypatch.setenv("REPRO_NO_FUSED_COMMIT", "1")
    assert backend.fused_commit_enabled() is False
    assert backend.fused_commit_enabled(True) is True


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """No silent CPU fallback: without a card and without device="cpu" the
    port's entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_staleness.build_staleness_randomness(0, 4, 3, 2.0)
    assert backend.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", sorted(tagg.ALGORITHMS))
def test_init_state_without_a_device_takes_the_card(monkeypatch, name):
    """With no device and no rows to take it from, a rule's state and the
    flat cache go on the card, so without one they raise; device="cpu"
    still builds them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    agg = tagg.ALGORITHMS[name]()
    state = agg.init_state(4, 8, device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(state))
    if _tensors(state):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agg.init_state(4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcache.init_flat_cache(4, 8, "int8")
    assert tcache.init_flat_cache(4, 8, "int8", device="cpu").data.device \
        == torch.device("cpu")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif hasattr(tree, "__dict__"):
        tree = list(vars(tree).values())
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def test_build_is_keyed_by_source_hash():
    names = {p.name for p in map(build.library_path, build.KERNELS)}
    assert len(names) == len(build.KERNELS)
    assert all(n.endswith(".so") and "-" in n for n in names)
    assert build.BUILD_DIR.name == "build"



def test_cpu_tensors_take_the_plain_version_for_the_new_kernels():
    x = torch.as_tensor(quant_rows(1, 64))
    mask = torch.tensor([True, False, True, True, False])
    before = ops.launch_counts()
    assert set(before) == {"cache_row_update", "row_delta", "commit_batch",
                           "masked_agg", "quantize_rows", "dequantize_rows"}
    q, s = ops.quantize_rows(x)
    q2, s2 = ops.quantize_rows(x, backend="torch")
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert torch.equal(ops.dequantize_rows(q, s),
                       tref.dequantize_rows_ref(q, s))
    assert torch.equal(ops.masked_agg(q, s, mask),
                       ops.masked_agg(q, s, mask, backend="torch"))
    assert ops.launch_counts() == before


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """`masked_agg`, `quantize_rows` and `dequantize_rows` launch on CUDA
    tensors only; a CPU tensor raises in the wrapper, and an unknown
    backend in the dispatch."""
    x = torch.as_tensor(quant_rows(2, 32))
    q, s = tref.quantize_rows_ref(x)
    mask = torch.ones(5, dtype=torch.bool)
    with pytest.raises(TypeError, match="CUDA tensor"):
        _q.quantize_rows(x)
    with pytest.raises(TypeError, match="CUDA tensor"):
        _q.dequantize_rows(q, s)
    with pytest.raises(TypeError, match="CUDA tensor"):
        _ma.masked_agg(q, s, mask)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.masked_agg(q, s, mask, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.quantize_rows(x, backend="pallas")


# --- launch geometry of the quantizer kernels (pure Python) -------------------

H100_SMS = 132
QUANT_SHAPES = [(1, 1), (1, 3), (1, 4), (1, 5), (2, 7), (1, 17226),
                (1, 17227), (3, 1), (100, 17226), (100, (1 << 22) + 3),
                # n·d around 2^31, on both sides
                (65536, 32767), (1, (1 << 31) - 1), (2, 1 << 30),
                (512, (1 << 22) + 1)]


GRID_BLOCKS = _q.GRID_BLOCKS_PER_SM * H100_SMS      # co-resident blocks


def grid_ranges(n, d, per_row, phase):
    """The grid's split of x (n, d) whose first element lies `phase`
    elements before a 16-byte boundary, mirrored in Python: block b serves
    row b // per_row as rank b % per_row, and a row's blocks split it as
    `_quant_slices` does from that row's own phase -> every [lo, hi) range
    of x's flat elements, by block."""
    out = []
    for row, rank in (divmod(b, per_row) for b in range(n * per_row)):
        head = (phase - row * d) % 4        # to the row's 16-byte line
        out.append([(row * d + lo, row * d + hi) for lo, hi in
                    _q._quant_slices(d, head, per_row)[rank]])
    return out


def assert_tiles(ranges, total):
    """`ranges` cover [0, total) exactly once."""
    ranges = sorted(r for block in ranges for r in block)
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n,d", QUANT_SHAPES)
def test_quant_plan_geometry(n, d):
    """Every quantize_rows plan (the rule's, each forced cluster and the
    forced grid) stays within CUDA's limits and the block's on-chip
    capacity — a grid within the blocks the card holds at once —, and its
    slices tile each row exactly once, whatever x's 16-byte phase."""
    if n > GRID_BLOCKS:
        with pytest.raises(ValueError, match="no grid"):
            _q._quant_plan(n, d, H100_SMS, on_chip="grid")
    for forced in (None, 1, 2, 4, 8, "grid"):
        if forced == "grid" and n > GRID_BLOCKS:
            continue
        C, T, V, on_chip = (
            _q._quant_plan(n, d, H100_SMS, on_chip="grid")
            if forced == "grid" else
            _q._quant_plan(n, d, H100_SMS, cluster=forced))
        if on_chip == "grid":
            assert forced in (None, "grid")
            assert C >= 1 and n * C <= GRID_BLOCKS
            assert T == _q.GRID_THREADS and V in (4, 8)
            assert C == max(1, min(GRID_BLOCKS // n, -(-(d // 4) // (
                T * _q.GRID_VECTORS))))
            for phase in range(4):
                assert_tiles(grid_ranges(n, d, C, phase), n * d)
            continue
        assert C in (1, 2, 4, 8) and forced in (None, C)
        assert n * C < 2 ** 31 and T % 32 == 0 and 32 <= T <= _q.MAX_THREADS
        most = -(-(d // 4) // C)             # vectors of the largest slice
        if on_chip == "registers":
            assert V in (2, 4, 8) and most <= T * V
        elif on_chip == "shared":
            assert most > 8 * _q.MAX_THREADS and 16 * most <= _q.SMEM_BYTES
        else:
            assert on_chip == "stream" and 16 * most > _q.SMEM_BYTES
        for head in range(4):
            slices = _q._quant_slices(d, head, C)
            assert len(slices) == C
            ranges = sorted(r for block in slices for r in block)
            assert ranges[0][0] == 0 and ranges[-1][1] == d
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(hi - lo <= max(4 * most, 3)
                       for block in slices for lo, hi in block)


def test_quant_plan_cluster_rule():
    """A row spreads over the largest cluster that leaves each block 128
    vectors; a thread holds as few vectors as the card's resident threads
    allow; a forced place the slice does not fit raises. A row of
    `GRID_MIN_D` numbers or more goes to the cooperative grid while its n
    clusters of 8 would leave most SMs idle (n·8 ≤ 66 of 132), on as many
    blocks as leave each thread `GRID_VECTORS` vectors, at most the card's
    co-resident blocks; it keeps the cluster beyond; the row kernels'
    plans stay clusters."""
    assert _q._quant_plan(1, 17226, H100_SMS)[:3] == (8, 288, 2)
    assert _q._quant_plan(100, 17226, H100_SMS)[:3] == (8, 160, 4)
    assert _q._quant_plan(1, 700, H100_SMS)[0] == 1
    assert _q._quant_plan(1, 2048, H100_SMS)[0] == 4
    assert _q._quant_plan(3, 17226, H100_SMS, on_chip="shared")[3] == \
        "shared"
    with pytest.raises(ValueError, match="does not fit"):
        _q._quant_plan(1, 1 << 20, H100_SMS, cluster=1, on_chip="registers")
    # the grid: rows from GRID_MIN_D numbers while n·8 ≤ 66
    short = _q.GRID_MIN_D - 4
    assert _q._quant_plan(1, short, H100_SMS)[3] == "registers"
    assert _q._quant_plan(1, _q.GRID_MIN_D, H100_SMS) == (
        _q.GRID_MIN_D // 4 // (256 * _q.GRID_VECTORS), 256, _q.GRID_LOADS,
        "grid")
    longest = 8 * 4 * (_q.SMEM_BYTES // 16)     # a cluster's shared reach
    assert _q._cluster_plan(1, longest, H100_SMS)[3] == "shared"
    assert _q._quant_plan(1, longest, H100_SMS)[3] == "grid"
    assert _q._quant_plan(1, 1 << 24, H100_SMS) == (
        GRID_BLOCKS, 256, _q.GRID_LOADS, "grid")
    assert _q._quant_plan(9, _q.GRID_MIN_D, H100_SMS)[3] == "registers"
    assert _q._quant_plan(8, 1 << 24, H100_SMS)[:2] == (GRID_BLOCKS // 8,
                                                       256)
    assert _q._quant_plan(9, 1 << 24, H100_SMS) == (8, 1024, 4, "stream")
    assert _q._quant_plan(100, (1 << 22) + 3, H100_SMS) == (
        8, 1024, 4, "stream")
    assert _q._quant_plan(2, 1 << 24, H100_SMS, 5, "grid")[0] == 5
    assert _q._quant_plan(1, 1 << 24, H100_SMS, cluster=8)[3] == "stream"
    with pytest.raises(ValueError, match="no grid"):
        _q._quant_plan(GRID_BLOCKS + 1, 64, H100_SMS, on_chip="grid")
    with pytest.raises(ValueError, match="no grid"):
        _q._quant_plan(2, 1 << 24, H100_SMS, GRID_BLOCKS, "grid")
    for d in (1 << 24, 45088768):
        assert _rd._row_plan(d, H100_SMS) == (8, 1024, 4, "grid")
        assert _cu._ace_plan(d, H100_SMS) == (8, 1024, 4, "grid")


# the real models' leaves that the grid takes: every leaf of 2^20 numbers or
# more of yi-9b at one layer (chip_smoke.py 4f) and of zamba2-1.2b at seven
# (4g), by the one row a tick writes and by the 8 rows of an int8 cache
YI_LEAVES = (2097152, 16777216, 45088768, 262144000)
ZAMBA2_LEAVES = (4194304, 8388608, 16777216, 17170432, 65536000)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("d", sorted(set(YI_LEAVES + ZAMBA2_LEAVES)))
def test_quant_grid_takes_the_real_models_leaves(n, d):
    """yi-9b's and zamba2-1.2b's long leaves by 1 and 8 rows take the
    cooperative grid, the card's co-resident blocks split evenly over the
    rows (fewer where that leaves a thread under `GRID_VECTORS` vectors),
    8 loads a thread in flight where a thread walks `GRID_DEEP_VECTORS`
    vectors or more (yi's embedding row, its MLP leaves by 8 rows);
    the main path's rows keep their cluster plans: (1, 17,226),
    (100, 17,226) and the text task's (1, 70,996)."""
    C = min(GRID_BLOCKS // n, d // 4 // (256 * _q.GRID_VECTORS))
    deep = d // 4 >= C * 256 * _q.GRID_DEEP_VECTORS     # 8 loads a thread
    assert _q._quant_plan(n, d, H100_SMS) == (
        C, _q.GRID_THREADS, 8 if deep else _q.GRID_LOADS, "grid")
    if (n, d) in ((1, 262144000), (8, 45088768)):
        assert deep
    assert _q._quant_plan(1, 17226, H100_SMS) == (8, 288, 2, "registers")
    assert _q._quant_plan(100, 17226, H100_SMS) == (8, 160, 4, "registers")
    assert _q._quant_plan(1, 70996, H100_SMS) == (8, 576, 4, "registers")


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_names", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::quantize_rows_grid_kernel<8>(float "
     "const*, signed char*, float*, float*, long long, int)",
     "quantize_rows"),
    ("void (anonymous namespace)::quantize_rows_kernel<0, 2>(float const*, "
     "signed char*, float*, long long)", "quantize_rows"),
    ("void (anonymous namespace)::dequantize_rows_kernel<4, true, unsigned "
     "int>(signed char const*, float const*, float*, unsigned int, unsigned "
     "int, unsigned int, unsigned int)", "dequantize_rows"),
    ("void (anonymous namespace)::row_delta_grid_kernel(float const*, ...)",
     "row_delta"),
    ("void (anonymous namespace)::cache_update_grid_kernel<float>(...)",
     "cache_row_update")])
def test_trace_names_count_each_kernel_once(name, kernel):
    """chip_smoke.py's traces count a launch by its kernel's name
    (`KERNEL_SYMBOLS`, matched where a name starts): quantize_rows' grid and
    cluster kernels as quantize_rows, never as dequantize_rows, and
    dequantize_rows_kernel as dequantize_rows alone; every name as exactly
    one of the six kernels."""
    cs = _chip_smoke()
    seen = [k for k, sym in cs.KERNEL_SYMBOLS.items()
            if cs.symbol_matches(sym, name)]
    assert seen == [kernel]
    assert re.search(cs.LM_GROUPS["quant kernels"], name) or \
        kernel not in ("quantize_rows", "dequantize_rows")


GRID_SPLIT_SHAPES = [(1, 1), (1, 5), (2, 7), (3, 4099), (1, (1 << 20) + 3),
                     (5, (1 << 20) + 1), (GRID_BLOCKS, 17226),
                     # n·d around 2^31, on both sides
                     (1, (1 << 31) - 1), (2, 1 << 30), (3, 715827883),
                     (8, (1 << 28) - 1), (512, (1 << 22) + 1),
                     (GRID_BLOCKS, 4067203)]


@pytest.mark.parametrize("n,d", GRID_SPLIT_SHAPES)
def test_quant_grid_split_tiles_every_element(n, d):
    """The grid's split of x, rows over blocks and each row over its
    blocks, covers every element of the n·d exactly once at each phase of
    x's first element against a 16-byte line (each row's own head then
    differs where d is not a multiple of 4), at the plan's blocks a row and
    at an odd count; no block's slice is longer than its share of the row's
    vectors plus the head or tail; past 2^31 elements the offsets need 64
    bits, as the kernel keeps them."""
    plans = {_q._quant_plan(n, d, H100_SMS, on_chip="grid")[0]}
    if GRID_BLOCKS // n >= 3:
        plans.add(3)
    for per_row in plans:
        share = 4 * -(-(d // 4) // per_row)
        for phase in range(4):
            ranges = grid_ranges(n, d, per_row, phase)
            assert len(ranges) == n * per_row
            assert_tiles(ranges, n * d)
            assert all(hi - lo <= max(share, 3)
                       for block in ranges for lo, hi in block)
            if n * d > 2 ** 31:
                assert max(hi for b in ranges for _, hi in b) > 2 ** 31


def test_quant_long_row_plain_matches_jax():
    """The plain quantizer, which the grid is held to on the card, against
    JAX's reference at a row of 2^20 + 3 with its |max| in the range of
    the grid's last block, and a row with a NaN there: q bit for bit, the
    scales bit for bit (NaN for NaN)."""
    d = (1 << 20) + 3
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, d)).astype(np.float32)
    per_row = _q._quant_plan(2, d, H100_SMS)[0]
    (lo, hi), = [r for r in _q._quant_slices(d, 0, per_row)[-1]
                 if r[1] - r[0] > 3]
    x[0, (lo + hi) // 2] = np.float32(-93.75)     # the row's |max|
    x[1, hi - 1] = np.nan
    q1, s1 = tref.quantize_rows_ref(_t(x))
    q2, s2 = jref.quantize_rows_ref(jnp.asarray(x))
    _same(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    assert float(s1[0]) == np.float32(93.75) / np.float32(127.0)
    assert q1[0, (lo + hi) // 2] == -127 and np.isnan(float(s1[1]))
    assert not q1[1].any()


AGG_SHAPES = [(1, 1), (7, 1), (1, 17226), (100, 17226), (9, 1001),
              (3000, 513), (100, (1 << 22) + 3), (128, 16), (129, 300)]


@pytest.mark.parametrize("n,d", AGG_SHAPES)
def test_masked_agg_plan_geometry(n, d):
    """masked_agg's plan: tiles of FEATURES columns, one a block, cover d
    exactly once; a chunk stages at most MAX_ROWS rows (one weight a
    thread) and every row is staged by one chunk; a row's tile, at any byte
    phase of its first 16-byte word, lies inside the FEATURES/16 + 1 words
    staged for it; the block's shared memory stays under 48 KB."""
    F = _ma.FEATURES
    rows, blocks = _ma._agg_plan(n, d)
    assert F % 32 == 0 and _ma.MAX_ROWS <= F
    assert (blocks - 1) * F < d <= blocks * F and blocks < 2 ** 31
    assert 1 <= rows <= min(max(n, 1), _ma.MAX_ROWS)
    assert sum(min(rows, n - c0) for c0 in range(0, n, rows)) == n
    words = F // 16 + 1
    assert all(phase + F <= 16 * words for phase in range(16))
    assert rows * 16 * words <= 48 * 1024


@pytest.mark.parametrize("d", [1, 7, 300, 17226, 131072, 131076,
                               (1 << 24) + 3])
def test_row_delta_plan_geometry(d):
    """The fused row swap launches one cluster on quantize_rows' plan for one
    row: the main path's width keeps its slices in registers (8 blocks of
    288 threads, 2 vectors a thread), a row that would take more than 4
    vectors a thread goes to the cooperative grid, and a cluster's slices
    tile the row exactly once."""
    C, T, V, on_chip = _rd._row_plan(d, H100_SMS)
    assert C in (1, 2, 4, 8) and T % 32 == 0 and T <= _q.MAX_THREADS
    if d == 17226:
        assert (C, T, V, on_chip) == (8, 288, 2, "registers")
    if on_chip == "grid":
        assert -(-(d // 4) // 8) > 4 * _q.MAX_THREADS   # past 4 a thread
        return
    assert on_chip == "registers" and V <= 4
    assert -(-(d // 4) // C) <= T * V
    for head in range(4):
        ranges = sorted(r for block in _q._quant_slices(d, head, C)
                        for r in block)
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("d", [1, 7, 300, 17226, 65536, 65540, 131072,
                               (1 << 24) + 3])
def test_ace_plan_geometry(d):
    """The whole ACE step launches one cluster on quantize_rows' plan for one
    row while that keeps 2 vectors a thread (the main path's width: 8
    blocks of 288 threads), else the cooperative grid; a cluster's slices
    fit its threads at 2 vectors and tile the row exactly once."""
    C, T, V, on_chip = _cu._ace_plan(d, H100_SMS)
    if d == 17226:
        assert (C, T, V, on_chip) == (8, 288, 2, "registers")
    if on_chip == "grid":
        assert -(-(d // 4) // 8) > 2 * _q.MAX_THREADS   # past 2 a thread
        return
    assert on_chip == "registers" and V == _cu.MAX_PER_THREAD == 2
    assert C in (1, 2, 4, 8) and T % 32 == 0 and T <= _q.MAX_THREADS
    assert -(-(d // 4) // C) <= T * V
    for head in range(4):
        ranges = sorted(r for block in _q._quant_slices(d, head, C)
                        for r in block)
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n,d", QUANT_SHAPES)
def test_dequant_plan_geometry(n, d):
    """dequantize_rows' split of the n·d flat codes: a scalar head that
    aligns x to 16 bytes, whole vectors of 4 codes with d ≥ 4 (so a vector
    crosses at most one row boundary), a scalar tail, one vector a thread;
    q vector-loaded exactly where its alignment agrees with x's; the grid
    within CUDA's limits and the 32-bit index arithmetic (n·d < 2^31) free
    of overflow."""
    N = n * d
    for q_off in range(16):
        for x_off in (0, 4, 8, 12):
            head, W, vec_q, T, blocks = _q._dequant_plan(
                n, d, 4096 + q_off, 8192 + x_off)
            assert W == (1 if d < 4 else 4)
            vectors, tail = divmod(N - head, W)
            assert 0 <= head < 4 and 0 <= tail < W
            if W > 1:
                assert (x_off + 4 * head) % 16 == 0
                assert vec_q == ((q_off + head) % 4 == 0)
                if q_off == 0 and x_off == 0:       # fresh allocations
                    assert vec_q and head == 0
            assert T % 32 == 0 and T <= _q.MAX_THREADS
            assert vectors <= T * blocks < vectors + T + 1
            assert 1 <= blocks < 2 ** 31 and max(head, tail) <= T
            if N < 2 ** 31:         # thread index, (r + 1)·d, i + 4
                assert T * blocks < 2 ** 31 and N + d < 2 ** 32
