"""The port's text task (`repro_torch.core.fl_tasks.make_text_task`, the
Table a.2 20 Newsgroups stand-in) against the JAX package's on the same
data, the same initial model and the same random streams:

  * the token data and the Dirichlet split are JAX's arrays;
  * at vocab 32, width 8, sequence 6 and 5 classes, the loss and the
    gradient of a batch of lanes (each lane its own model and client)
    agree with JAX's within 1e-6;
  * `run_staleness_scan` on the text task (ACE f32 K = 1, ACED int8 K = 4,
    CA²FL int8 K = 1) agrees with JAX's within 1e-5, emission equal.
The JAX reference samples its minibatch with the port's rule,
``ix = min(floor(u · n_client), n_client − 1)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import fl_tasks as jtasks  # noqa: E402
from repro.core.scan_engine import default_n_events  # noqa: E402
from repro.core.scan_staleness import run_staleness_scan as jax_run  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fl_tasks as ttasks  # noqa: E402
from repro_torch.core.scan_staleness import run_staleness_scan as torch_run  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from test_torch_engine import _make, replay_streams  # noqa: E402

TEXT = dict(n_clients=6, alpha=1.0, batch=4, n_classes=5, vocab=32, d=8,
            seq_len=6, n_train=300, n_test=60, seed=0)


def jax_text_grad(kw):
    """`repro.core.fl_tasks.make_text_task`'s gradient from the JAX
    package's own pieces, its minibatch drawn with the port's rule."""
    x, y = jtasks.make_text_classification(
        kw["n_train"] + kw["n_test"], kw["n_classes"], kw["seq_len"],
        kw["vocab"], seed=kw["seed"])
    xtr, ytr = x[:kw["n_train"]], y[:kw["n_train"]]
    parts = jtasks.dirichlet_partition(ytr, kw["n_clients"], kw["alpha"],
                                       seed=kw["seed"] + 1)
    _, apply = jtasks.tiny_text_classifier(kw["vocab"], kw["d"],
                                           kw["n_classes"], kw["seq_len"])
    cx, cy, cn = jtasks._pad_clients(xtr, ytr, parts)
    batch = kw["batch"]

    def grad_fn(params, client, key):
        n_c = cn[client]
        u = jax.random.uniform(key, (batch,))
        ix = jnp.minimum(jnp.floor(u * n_c).astype(jnp.int32), n_c - 1)
        return jax.value_and_grad(
            lambda p: jtasks._xent(apply(p, cx[client][ix]),
                                   cy[client][ix]))(params)
    return grad_fn, lambda key: jax.random.uniform(key, (batch,))


@pytest.fixture(scope="module")
def tasks():
    jtask = jtasks.make_text_task(**TEXT)
    ttask = ttasks.make_text_task(**TEXT, device="cpu")
    params0 = convert.params_from_jax(jax.tree.map(np.asarray,
                                                   jtask.params0))
    return jtask, ttask, params0


def test_text_data_are_the_jax_packages():
    xj, yj = jsyn.make_text_classification(200, 7, 9, 50, seed=3)
    xt, yt = tsyn.make_text_classification(200, 7, 9, 50, seed=3)
    assert np.array_equal(xj, xt) and np.array_equal(yj, yt)
    assert xt.dtype == np.int32 and xt.shape == (200, 9)


def test_text_task_layout():
    """The port's parameters ravel in JAX's order (dict keys sorted: b1,
    b2, emb, w1, w2) to the same widths; at the defaults d = 70,996."""
    jtask = jtasks.make_text_task(**TEXT)
    ttask = ttasks.make_text_task(**TEXT, device="cpu")
    assert sorted(ttask.params0) == sorted(jtask.params0)
    for k, v in ttask.params0.items():
        assert tuple(v.shape) == jtask.params0[k].shape
    assert ttask.meta == {"alpha": 1.0, "kind": "text"}
    full = ttasks.make_text_task(device="cpu")
    assert full.n_clients == 20
    assert convert.ravel(full.params0).numel() == 70996


def test_text_loss_and_grad_match_jax(tasks):
    """B lanes, each its own model, client and minibatch draw: loss and
    gradient within 1e-6 of JAX's per-client value_and_grad."""
    jtask, ttask, params0 = tasks
    jgrad, _ = jax_text_grad(TEXT)
    flat0, unravel = jax.flatten_util.ravel_pytree(jtask.params0)
    rng = np.random.default_rng(1)
    B = 5
    w = np.asarray(flat0)[None] + 0.1 * rng.normal(size=(B, flat0.size))
    w = w.astype(np.float32)
    clients = np.array([0, 3, 5, 3, 1])
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    u = np.stack([np.asarray(jax.random.uniform(k, (TEXT["batch"],)))
                  for k in keys])
    loss_t, g_t = ttask.grad_fn(torch.as_tensor(w), torch.as_tensor(clients),
                                torch.as_tensor(u))
    for b in range(B):
        loss_j, g_j = jgrad(unravel(jnp.asarray(w[b])), int(clients[b]),
                            keys[b])
        flat_g = np.asarray(jax.flatten_util.ravel_pytree(g_j)[0])
        assert abs(float(loss_t[b]) - float(loss_j)) <= 1e-6
        assert np.max(np.abs(g_t[b].numpy() - flat_g)) <= 1e-6
    # one flat gradient a lane, in the ravel order of the parameters
    assert g_t.shape == (B, convert.ravel(params0).numel())


@pytest.mark.parametrize("name,dtype,K", [("ace", "float32", 1),
                                          ("aced", "int8", 4),
                                          ("ca2fl", "int8", 1)])
def test_text_run_staleness_matches_jax(tasks, name, dtype, K):
    """The text task end to end on the staleness engine: emission equal,
    final model and per-update losses within 1e-5, and the port's test
    accuracy of that model JAX's."""
    jtask, ttask, params0 = tasks
    jgrad, noise_of = jax_text_grad(TEXT)
    T, beta, seed, lr = 14, 2.0, 2, 0.5
    j_agg, t_agg = _make(name, dtype, K, "jax"), _make(name, dtype, K, "torch")
    n_events = default_n_events(j_agg, T)
    kw = dict(n_clients=TEXT["n_clients"], server_lr=lr, T=T, beta=beta,
              n_events=n_events, seed=seed, k_batch=K)
    jr = jax_run(grad_fn=jgrad, params0=jtask.params0, aggregator=j_agg,
                 **kw)
    rand, noise = replay_streams(seed, n_events, TEXT["n_clients"], beta, K,
                                 noise_of, (TEXT["batch"],),
                                 jagg.wants_cache_init(j_agg))
    tr = torch_run(grad_fn=ttask.grad_fn, params0=params0, aggregator=t_agg,
                   device="cpu", randomness=rand, payload_noise=noise, **kw)
    assert np.isfinite(tr.w).all() and len(tr.ts) > 0
    assert np.array_equal(tr.emit, jr.emit)
    assert np.max(np.abs(tr.w - np.asarray(jr.w))) <= 1e-5
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-5)
    acc_t = ttask.eval_fn(convert.unravel(torch.as_tensor(tr.w), params0))
    acc_j = jtask.eval_fn(jax.flatten_util.ravel_pytree(jtask.params0)[1](
        jnp.asarray(tr.w)))
    assert acc_t["accuracy"] == pytest.approx(acc_j["accuracy"], abs=1e-6)
