"""The rest of the rule zoo in the port — ASGD, delay-adaptive ASGD,
FedBuff and the direct ACE / ACED / CA²FL rules — against the JAX
package's rules on identical arrival streams, and the running vectors'
``state_dtype``.

int8 cache rows and scales must be bit-identical; f32 state, updates and
lr scales agree within 1e-5 (the repo's contract between engines). With a
bfloat16 state the port's running vectors must be bfloat16 tensors,
bit-identical to the JAX state at K = 1 and within one bfloat16 ulp per
element at K = 4 (where both sum K lanes, in their own orders, before the
one rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AFLConfig  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.core.scan_engine import default_n_events as jax_n_events  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import scan_engine as tengine  # noqa: E402

TOL = 1e-5
N, D, T = 8, 48, 24


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


def _stream(seed, K, max_staleness=30):
    """T ticks with strictly increasing t and one thaw jump (t leaps by 6
    at tick 12); distinct clients per tick; staleness values on both sides
    of the delay-adaptive threshold; for K > 1 some invalid (NaN-poisoned)
    lanes, among them an all-invalid tick."""
    rng = np.random.default_rng(seed)
    ts = np.arange(1, T + 1) + 5 * (np.arange(T) >= 12)
    clients = np.stack([rng.choice(N, size=K, replace=False)
                        for _ in range(T)])
    payloads = (rng.normal(size=(T, K, D)) * 3).astype(np.float32)
    staleness = rng.integers(0, max_staleness, size=(T, K)).astype(np.int32)
    valid = (rng.random((T, K)) < 0.8) | (K == 1)
    if K > 1:
        valid[7] = False
    payloads[~valid] = np.nan
    init = rng.normal(size=(N, D)).astype(np.float32)
    return ts, clients, payloads, staleness, valid, init


def _drive(agg, lib, stream, K, keep_dtypes=False):
    """Run `agg` over the stream; returns (final state, updates (T, d),
    emits (T,), lr scales (T,)). ``keep_dtypes`` casts every float state
    vector back to its initial dtype after each step (see
    `test_state_dtype_repair`)."""
    ts, clients, payloads, staleness, valid, init = stream
    arr = torch.as_tensor if lib == "torch" else jnp.asarray
    mod = tagg if lib == "torch" else jagg
    # the port's init_state takes the card unless told otherwise
    kw = {"device": "cpu"} if lib == "torch" else {}
    state = agg.init_state(N, D, arr(init) if mod.wants_cache_init(agg)
                           else None, **kw)
    dtypes = {k: v.dtype for k, v in dict(state).items()
              if hasattr(v, "dtype")}
    ups, emits, scales = [], [], []
    for e in range(T):
        if K == 1:
            state, u, emit, lr = agg.step(state, mod.Arrival(
                int(clients[e, 0]), arr(payloads[e, 0]), int(ts[e]),
                int(staleness[e, 0])))
        else:
            state, u, emit, lr = agg.step_batch(state, mod.ArrivalBatch(
                arr(clients[e]), arr(payloads[e]), int(ts[e]),
                arr(staleness[e]), arr(valid[e])))
        if keep_dtypes:
            state = {k: (v.astype(dtypes[k]) if k in dtypes else v)
                     for k, v in state.items()}
        ups.append(_np(u).astype(np.float32))
        emits.append(bool(emit))
        scales.append(float(lr))
    return state, np.stack(ups), np.array(emits), np.array(scales)


def _config(name, dtype="float32", K=1, state_dtype="float32"):
    return AFLConfig(algorithm=name, n_clients=N, cache_dtype=dtype,
                     state_dtype=state_dtype, tau_algo=3, buffer_size=3,
                     k_batch=K, max_delay_scale=2.0, delay_beta=5.0)


CASES = ([(r, "float32", K) for r in ("asgd", "delay_asgd", "fedbuff")
          for K in (1, 4)]
         + [(r, dt, 1) for r in ("ace_direct", "aced_direct", "ca2fl_direct")
            for dt in ("int8", "float32")])


@pytest.mark.parametrize("name,dtype,K", CASES)
def test_new_rule_matches_jax_on_one_stream(name, dtype, K):
    cfg = _config(name, dtype, K)
    t_agg, j_agg = tagg.make_aggregator(cfg), jagg.make_aggregator(cfg)
    assert type(t_agg).__name__ == type(j_agg).__name__
    stream = _stream(3, K)
    ts_, tu, te, tl = _drive(t_agg, "torch", stream, K)
    js_, ju, je, jl = _drive(j_agg, "jax", stream, K)
    assert np.array_equal(te, je)
    _close(tu[te], ju[je])
    _close(tl, jl)
    js_ = dict(js_)
    assert set(ts_) == set(js_)
    for k, v in ts_.items():
        if isinstance(v, tcache.FlatCache):
            _same_cache(v, js_[k])
        elif v.dtype.is_floating_point:
            _close(v, js_[k])
        else:
            assert np.array_equal(_np(v), _np(js_[k])), k
    if name == "delay_asgd":
        # the stream's staleness spans τ_C = 10, so some arrivals are
        # down-weighted: at K = 1 through lr_scale, at K > 1 inside update
        assert (tl < 1).any() if K == 1 else (tl == 1).all()


@pytest.mark.parametrize("name", ["ace_direct", "aced_direct",
                                  "ca2fl_direct"])
def test_direct_rules_take_single_arrivals_only(name):
    agg = tagg.make_aggregator(_config(name))
    state = agg.init_state(N, D, torch.zeros(N, D), device="cpu")
    batch = tagg.ArrivalBatch(torch.tensor([0, 1]), torch.zeros(2, D), 1,
                              torch.zeros(2, dtype=torch.int32),
                              torch.ones(2, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="K-batched"):
        agg.step_batch(state, batch)


def test_make_aggregator_builds_every_registered_rule():
    assert set(tagg.ALGORITHMS) == set(jagg.ALGORITHMS)
    for name, cls in tagg.ALGORITHMS.items():
        agg = tagg.make_aggregator(_config(name, "int8", 4, "bfloat16"))
        assert type(agg) is cls and agg.name == name
        assert (tagg.wants_cache_init(agg)
                == jagg.wants_cache_init(jagg.ALGORITHMS[name]()))
        assert getattr(agg, "state_dtype", "bfloat16") == "bfloat16"
    assert tagg.make_aggregator(_config("delay_asgd")).tau_c == 10.0
    assert tagg.make_aggregator(_config("aced", K=4)).max_cohort == 4
    with pytest.raises(ValueError, match="unknown AFL algorithm"):
        tagg.make_aggregator(_config("fedavg"))


def test_default_n_events_matches_jax_for_every_rule():
    """The event budget is the JAX one for every rule, headroom included
    for a rule whose emission is not guaranteed."""
    for name in tagg.ALGORITHMS:
        cfg = _config(name)
        for T_ in (1, 40):
            assert (tengine.default_n_events(tagg.make_aggregator(cfg), T_)
                    == jax_n_events(jagg.make_aggregator(cfg), T_))

    class Flaky(tagg.VanillaASGD):
        guaranteed_emit = False

    assert (tengine.default_n_events(Flaky(), 40)
            > tengine.default_n_events(tagg.VanillaASGD(), 40))


# --- the state_dtype repair -------------------------------------------------

def _bf16_ulp(x):
    """The spacing of bfloat16 at |x| (f32 spacing × 2^16)."""
    return np.spacing(np.abs(_np(x)).astype(np.float32)) * 2.0 ** 16


BF16_CASES = ([(r, K) for r in ("ace", "aced", "ca2fl", "fedbuff")
               for K in (1, 4)] + [("ca2fl_direct", 1)])


@pytest.mark.parametrize("name,K", BF16_CASES)
def test_state_dtype_repair(name, K):
    """``state_dtype="bfloat16"`` reaches the port's rules through
    `make_aggregator`: the running vectors are bfloat16 tensors, and they
    follow the JAX rules on one int8-cache stream.

    The JAX flat int8 ACE step at K = 1 returns an f32 u from a bfloat16
    state (its `cache_row_update` adds in f32 and does not cast back); the
    port stores u in the state dtype, as every other rule does. The JAX
    side is therefore cast back to its initial state dtypes after each
    step, which is a no-op for every other rule."""
    cfg = _config(name, "int8", K, "bfloat16")
    t_agg, j_agg = tagg.make_aggregator(cfg), jagg.make_aggregator(cfg)
    stream = _stream(5, K)
    ts_, tu, te, _ = _drive(t_agg, "torch", stream, K)
    js_, ju, je, _ = _drive(j_agg, "jax", stream, K, keep_dtypes=True)
    js_ = dict(js_)
    vecs = [k for k, v in ts_.items()
            if isinstance(v, torch.Tensor) and v.dtype.is_floating_point]
    assert vecs
    assert all(ts_[k].dtype == torch.bfloat16 for k in vecs)
    assert all(js_[k].dtype == jnp.bfloat16 for k in vecs)
    assert np.array_equal(te, je)
    for k, v in ts_.items():
        if isinstance(v, tcache.FlatCache):
            _same_cache(v, js_[k])
        elif k not in vecs:
            assert np.array_equal(_np(v), _np(js_[k])), k
    for k in vecs:
        a, b = _np(ts_[k]), _np(js_[k])
        if K == 1:
            assert np.array_equal(a, b), k
        else:
            assert np.all(np.abs(a - b) <= _bf16_ulp(b)), k
    if K == 1:
        # updates are f32 reads of the same bf16 state (ACE: the state)
        ju = ju.astype(jnp.bfloat16).astype(np.float32) if name == "ace" \
            else ju
        assert np.array_equal(tu[te], ju[je])
    else:
        _close(tu[te], ju[je], 2.0 ** -7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_ace_int8_step_keeps_its_input_state(state_dtype):
    """The int8 ACE step at K = 1 (one `ops.cache_row_update` call, the
    plain whole call on the CPU) against the JAX rule on the rules' stream:
    the cache and u bit for bit after every arrival (JAX's f32 u cast back
    to the state dtype). Each step returns a fresh u and leaves its input
    u as it was (the engine keeps the old state for a frozen tick), and its
    ``emit`` is one kept True, the same tensor every tick."""
    cfg = _config("ace", "int8", 1, state_dtype)
    t_agg, j_agg = tagg.make_aggregator(cfg), jagg.make_aggregator(cfg)
    ts, clients, payloads, staleness, _, init = _stream(7, 1)
    t_state = t_agg.init_state(N, D, torch.as_tensor(init), device="cpu")
    j_state = j_agg.init_state(N, D, jnp.asarray(init))
    j_dtype = j_state["u"].dtype
    # one start for both (the two means of the cache differ in the last bit)
    t_state["u"] = torch.as_tensor(np.array(_np(j_state["u"]))).to(
        t_state["u"].dtype)
    emits = set()
    for e in range(T):
        u_in = t_state["u"]
        u_copy = u_in.clone()
        t_state, tu, emit, _ = t_agg.step(t_state, tagg.Arrival(
            int(clients[e, 0]), torch.as_tensor(payloads[e, 0]), int(ts[e]),
            int(staleness[e, 0])))
        j_state, _, _, _ = j_agg.step(j_state, jagg.Arrival(
            int(clients[e, 0]), jnp.asarray(payloads[e, 0]), int(ts[e]),
            int(staleness[e, 0])))
        j_state = {**j_state, "u": j_state["u"].astype(j_dtype)}
        assert torch.equal(u_in, u_copy) and tu is t_state["u"]
        assert tu.data_ptr() != u_in.data_ptr()
        assert bool(emit) and emit.dtype == torch.bool
        emits.add(id(emit))
        _same_cache(t_state["cache"], j_state["cache"])
        assert np.array_equal(_np(tu), _np(j_state["u"]))
    assert len(emits) == 1


@pytest.mark.parametrize("name", ["ace", "aced", "ca2fl"])
def test_bf16_state_keeps_step_batch_off_the_fused_commit(name, monkeypatch):
    """A non-f32 state takes the op chain at K > 1, like the JAX rules;
    an f32 state takes the fused commit."""
    calls = []
    real = tagg.flat_commit_batch
    monkeypatch.setattr(tagg, "flat_commit_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for sd, fused in (("bfloat16", False), ("float32", True)):
        calls.clear()
        agg = tagg.make_aggregator(_config(name, "int8", 4, sd))
        _drive(agg, "torch", _stream(6, 4), 4)
        assert bool(calls) is fused
