"""The port's optimizers, schedules and data functions against the JAX
package's: `sgd`, `sgd_momentum` (Nesterov on and off) and `adamw` (with
and without weight decay, a schedule for the lr) over five steps of a
parameter structure within 1e-6; `sqrt_nt_schedule` and
`cosine_schedule` equal; `make_token_stream`, `batch_iterator` and
`label_histograms` giving the same arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)


def tree(seed):
    """A parameter structure of dicts, a list and a tuple."""
    rng = np.random.default_rng(seed)

    def a(*s):
        return rng.normal(size=s).astype(np.float32)
    return {"w": a(4, 3), "stages": [({"k": a(2, 5)}, {"b": a(5)})],
            "emb": {"embedding": a(7, 3)}}


def jtree(x):
    return jax.tree.map(jnp.asarray, x)


def ttree(x):
    return convert.tree_map(lambda v: torch.as_tensor(v), x)


OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.sgd_momentum(0.05),
    "nesterov": lambda m: m.sgd_momentum(0.05, momentum=0.8, nesterov=True),
    "adamw": lambda m: m.adamw(0.1),
    "adamw_wd": lambda m: m.adamw(0.01, weight_decay=0.1),
    "adamw_cosine": lambda m: m.adamw(m.cosine_schedule(0.1, 2, 5)),
    "sgd_sqrt_nt": lambda m: m.sgd(m.sqrt_nt_schedule(0.5, 8, 200)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_steps_match_jax(name):
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    jp, tp = jtree(tree(0)), ttree(tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = tree(10 + step)
        ju, js = jo.update(jtree(g), js, jp)
        tu, ts = to.update(ttree(g), ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = convert.tree_map(lambda p, u: p + u, tp, tu)
        jl, tl = jax.tree.leaves(jp), convert.leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32
    for a, b in zip(convert.leaves({k: v for k, v in ts.items()
                                    if k != "step"}),
                    jax.tree.leaves({k: v for k, v in js.items()
                                     if k != "step"})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_schedules_match_jax():
    assert topt.sqrt_nt_schedule(0.5, 8, 200)(3) == \
        jopt.sqrt_nt_schedule(0.5, 8, 200)(3) == pytest.approx(0.1)
    for peak, warm, total, floor in ((0.1, 10, 100, 0.0), (1.0, 0, 50, 0.1),
                                     (0.3, 5, 5, 0.01)):
        jf = jopt.cosine_schedule(peak, warm, total, floor)
        tf = topt.cosine_schedule(peak, warm, total, floor)
        for t in (0, 1, warm, warm + 1, total // 2, total, total + 7):
            assert float(tf(t)) == pytest.approx(float(jf(t)), rel=1e-6,
                                                 abs=1e-7)
            assert float(tf(torch.tensor(t, dtype=torch.int32))) == \
                float(tf(t))


@pytest.mark.parametrize("n,vocab,order,seed", [(1000, 64, 2, 5),
                                                (4096, 128, 3, 0),
                                                (2000, 64000, 2, 1)])
def test_token_stream_matches_jax(n, vocab, order, seed):
    t = tsyn.make_token_stream(n, vocab=vocab, order=order, seed=seed)
    j = jsyn.make_token_stream(n, vocab=vocab, order=order, seed=seed)
    assert t.dtype == j.dtype and np.array_equal(t, j)
    assert t.max() < vocab


def test_batch_iterator_matches_jax():
    x, y = jsyn.make_classification(200, seed=2)
    ti = tsyn.batch_iterator(x, y, 16, seed=4)
    ji = jsyn.batch_iterator(x, y, 16, seed=4)
    for _ in range(5):
        (tx, ty), (jx, jy) = next(ti), next(ji)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


@pytest.mark.parametrize("n_clients,alpha", [(2, 0.05), (7, 0.5), (20, 10.0)])
def test_label_histograms_match_jax(n_clients, alpha):
    labels = np.random.default_rng(0).integers(0, 5, size=500)
    parts = tpart.dirichlet_partition(labels, n_clients, alpha, seed=1)
    h = tpart.label_histograms(labels, parts)
    assert np.array_equal(h, jpart.label_histograms(labels, parts))
    assert h.sum() == 500 and h.shape == (n_clients, 5)
