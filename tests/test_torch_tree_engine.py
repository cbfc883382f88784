"""The port's staleness engine in the tree layout against the JAX package's
``layout="tree"`` on the same data, initial model and random streams (the
JAX streams replayed through ``randomness=`` / ``payload_noise=``, as in
tests/test_torch_engine.py), on a narrow vision MLP (a list of three
``{w, b}`` layers: six leaves of rank 1 and 2).

ASGD and FedBuff (no cache) and CA²FL, ACE and ACED with f32 and int8 tree
caches, at K = 1 and K = 3: the final model (a parameter structure) within
1e-5, the emitted ticks identical, the losses and update norms within
1e-5, and the rule's final tree state — caches, running sums, counters —
against JAX's within 1e-5.

The MLP gradients of the two packages differ by the order of their f32
sums (~1e-7 relative). On an f32 cache that stays at 1e-7; on an int8
cache it can move a payload across a rounding boundary and one code by one
step, which then moves the model by a quantization step (CA²FL int8 K = 3
here: 3e-4), not by a drift. So the int8 runs share one client gradient:
JAX's engine calls the port's MLP gradient through `jax.pure_callback`
(its minibatch uniforms still drawn from JAX's key chain), and both engines
quantize the same payloads; what differs is only the two engines' own f32
arithmetic. The f32 runs and the no-cache rules use each package's own
gradient. With the shared gradient the int8 codes of every run equal
JAX's bit for bit; on equal inputs the codes and scales are also held bit for bit in
tests/test_torch_tree_cache.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import make_staleness_runner as jax_runner  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.scan_staleness import make_staleness_runner as torch_runner  # noqa: E402
from test_torch_engine import jax_vision_grad, replay_streams  # noqa: E402

torch.set_num_threads(1)

# n = 6 clients, d = 180 over six leaves
VISION = dict(n_clients=6, alpha=0.3, batch=4, n_classes=10, dim=6,
              hidden=(8, 6), n_train=300, n_test=60, seed=0)
T, BETA, SEED, LR = 12, 2.0, 1, 0.2


def make_rule(lib, name, dtype, K):
    mod = tagg if lib == "torch" else jagg
    if name == "asgd":
        return mod.VanillaASGD()
    if name == "fedbuff":
        return mod.FedBuff(buffer_size=2)
    if name == "ca2fl":
        return mod.CA2FL(buffer_size=2, cache_dtype=dtype)
    if name == "ace":
        return mod.ACEIncremental(cache_dtype=dtype)
    return mod.ACED(tau_algo=3, cache_dtype=dtype, max_cohort=K)


def tasks():
    jtask = jtasks.make_vision_task(**VISION)
    ttask = ttasks.make_vision_task(**VISION, device="cpu")
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    return jtask, ttask, params0


def shared_grad(ttask):
    """The port's MLP gradient as a JAX client gradient ``(params, client,
    key) -> (loss, grads)``: the minibatch uniforms drawn from `key` as
    `jax_vision_grad` draws them, the gradient computed by the port on the
    host through `jax.pure_callback` (a K-lane tick calls it lane by
    lane)."""
    B = VISION["batch"]

    def host(params, client, u):
        p = convert.tree_map(lambda x: torch.as_tensor(np.array(x))[None],
                             params)
        loss, g = ttask.grad_fn(
            p, torch.as_tensor(np.array(client)).reshape(1),
            torch.as_tensor(np.array(u))[None])
        return (np.float32(loss[0].numpy()),
                convert.tree_map(lambda x: x[0].numpy(), g))

    def grad_fn(params, client, key):
        u = jax.random.uniform(key, (B,))
        shapes = (jax.ShapeDtypeStruct((), jnp.float32),
                  jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                              jnp.float32),
                               params))
        return jax.pure_callback(host, shapes, params, client, u,
                                 vmap_method="sequential")
    return grad_fn


def both_runs(name, dtype, K, *, history_dtype="float32", n_events=None,
              shared=False):
    """The JAX tree runner and the port's on the JAX streams -> (JAX's
    (w, state, outs) as numpy, the port's (w, state, outs)); `shared`
    gives JAX the port's client gradient (`shared_grad`)."""
    jtask, ttask, params0 = tasks()
    jgrad, noise_of = jax_vision_grad(VISION)
    if shared:
        jgrad = shared_grad(ttask)
    j_agg = make_rule("jax", name, dtype, K)
    if n_events is None:
        n_events = default_n_events(j_agg, T)
    kw = dict(n_clients=VISION["n_clients"], T=T, beta=BETA, k_batch=K,
              layout="tree", history_dtype=history_dtype)
    jrun = jax_runner(grad_fn=jgrad, params0=jtask.params0, aggregator=j_agg,
                      **kw)
    rand, noise = replay_streams(SEED, n_events, VISION["n_clients"], BETA,
                                 K, noise_of, (VISION["batch"],),
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
    tw, ts, touts, _ = trun(rand, noise, LR)
    host = jax.tree.map(np.asarray, (jw, js, jouts))
    return host, (tw, ts, touts)


def close(t, j, tol=1e-5):
    """Leaf for leaf in JAX's order: integer leaves exactly, floats within
    `tol` (relative to the larger of 1 and the leaf's magnitude)."""
    tl, jl = convert.leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape
        if not np.issubdtype(b.dtype, np.floating):
            assert np.array_equal(a, b)
        else:
            b = b.astype(np.float32)
            assert np.max(np.abs(a.astype(np.float64) - b), initial=0.0) \
                <= tol * max(1.0, float(np.max(np.abs(b), initial=0.0)))


def same_int8_cache(t, j):
    """int8 codes bit for bit, scales within 1e-5 relative (the engines'
    own f32 arithmetic moves a scale by ~1e-9)."""
    tl, jl = tcache.cache_tensors(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.int8:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


CASES = ([(r, None, K) for r in ("asgd", "fedbuff") for K in (1, 3)]
         + [(r, dt, K) for r in ("ca2fl", "ace", "aced")
            for dt in ("float32", "int8") for K in (1, 3)])


@pytest.mark.parametrize("name,dtype,K", CASES)
def test_tree_run_matches_jax_tree(name, dtype, K):
    (jw, js, jouts), (tw, ts, touts) = both_runs(
        name, dtype or "float32", K, shared=dtype == "int8")
    assert isinstance(tw, list) and len(convert.leaves(tw)) == 6
    close(tw, jw)
    assert np.array_equal(touts["emit"].numpy(), jouts["emit"])
    assert np.array_equal(touts["t"].numpy(), jouts["t"])
    np.testing.assert_allclose(touts["loss"].numpy(), jouts["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(touts["unorm"].numpy(), jouts["unorm"],
                               rtol=1e-5, atol=1e-5)
    if isinstance(js, tuple):                 # ASGD keeps no state
        assert ts == {}
        return
    assert sorted(ts) == sorted(js)
    for k in ts:
        if tcache.is_tree_cache(ts[k]):
            assert tcache.is_tree_cache(convert.tree_cache_from_jax(js[k]))
            if dtype == "int8":
                same_int8_cache(ts[k], js[k])
            else:
                close(tcache.cache_tensors(ts[k]), js[k])
        else:
            close(ts[k], js[k])
