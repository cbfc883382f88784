"""The port's Mamba-2 SSD block (`repro_torch.models.ssm`) and MoE FFN
(`repro_torch.models.moe`) against the JAX package's on the same inputs
(numpy draws) and weights (a JAX init carried across by
`repro_torch.convert.params_from_jax`), each within 1e-5·max(1, max|JAX|):

  * `ssd_chunked` on tests/test_ssm.py's parametrisation (groups, chunk,
    L), from a zero and from a given `init_state`: y, the final state and
    the gradients of a loss on both (finite: the segment sum's −inf fill
    gives zero gradients, not NaNs), and against the step recurrence;
  * `mamba_apply` (output and every gradient) and `mamba_decode` step by
    step (outputs and the conv and state caches);
  * `moe_apply`'s y, aux loss and gradients (input and every weight), at
    a capacity that keeps every token, at capacity factor 1.0 (tokens
    dropped) and decode-shaped (L = 1: one group of B tokens); the
    backward gathers (no scatter-add) and two gradients are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_ssm import naive_ssd  # noqa: E402

torch.set_num_threads(1)


def _cfg(groups=1, chunk=8):
    """tests/test_ssm.py's configuration."""
    return ModelConfig(name="x", family="ssm", num_layers=1, d_model=64,
                       num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=8,
                       head_dim=1, ssm_state=8, ssm_head_dim=16,
                       ssm_chunk=chunk, ssm_groups=groups)


MOE = ModelConfig(name="moe", family="moe", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                  head_dim=16, num_experts=4, num_experts_per_tok=2,
                  moe_d_ff=64, capacity_factor=4.0)


def port_cfg(cfg):
    return tbase.ModelConfig(**dataclasses.asdict(cfg))


def close(t, j, tol=1e-5):
    j = np.asarray(j)
    t = t.detach().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.all(np.isfinite(t))
    err = np.max(np.abs(t - j), initial=0.0)
    assert err <= tol * max(1.0, float(np.max(np.abs(j), initial=0.0))), err


def ssd_inputs(cfg, L, seed, with_state):
    rng = np.random.default_rng(seed)
    B, H, P, G, N = (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                     cfg.ssm_state)
    xs = [rng.normal(size=(B, L, H, P)) * 0.5,
          -np.abs(rng.normal(size=(B, L, H))) * 0.3,
          rng.normal(size=(B, L, G, N)) * 0.5,
          rng.normal(size=(B, L, G, N)) * 0.5]
    if with_state:
        xs.append(rng.normal(size=(B, H, P, N)) * 0.5)
    return [x.astype(np.float32) for x in xs]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("groups,chunk,L", [(1, 8, 32), (2, 8, 32),
                                            (1, 16, 16), (2, 4, 20)])
def test_ssd_chunked_matches_jax(groups, chunk, L, with_state):
    """y and the final state, and the gradients of ``sum(y·r) +
    sum(final·s)`` with respect to every input, within 1e-5 of JAX's; y
    and the state also against the step recurrence (test_ssm.py's 1e-4)."""
    cfg = _cfg(groups, chunk)
    xs = ssd_inputs(cfg, L, 1 + L + groups, with_state)
    rng = np.random.default_rng(9)
    B, H, P, N = 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    r = rng.normal(size=(B, L, H, P)).astype(np.float32)
    s = rng.normal(size=(B, H, P, N)).astype(np.float32)

    def jloss(*a):
        y, f = jssm.ssd_chunked(*a[:4], cfg, init_state=a[4] if with_state
                                else None)
        return jnp.sum(y * r) + jnp.sum(f * s), (y, f)
    (_, (jy, jf)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(xs))), has_aux=True))(
        *(jnp.asarray(x) for x in xs))
    ts = [torch.as_tensor(x).requires_grad_(True) for x in xs]
    ty, tf = tssm.ssd_chunked(*ts[:4], port_cfg(cfg),
                              init_state=ts[4] if with_state else None)
    tg = torch.autograd.grad((ty * torch.as_tensor(r)).sum()
                             + (tf * torch.as_tensor(s)).sum(), ts)
    close(ty, jy)
    close(tf, jf)
    for a, b in zip(tg, jg):
        close(a, b)
    if not with_state:
        ref_y, ref_h = naive_ssd(*xs)
        np.testing.assert_allclose(ty.detach().numpy(), ref_y, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tf.detach().numpy(), ref_h, rtol=1e-4,
                                   atol=1e-4)


def test_ssd_init_state_continuation():
    """tests/test_ssm.py::test_ssd_init_state_continuation on the port: two
    halves with the carried state equal the whole sequence."""
    cfg = port_cfg(_cfg(1, 8))
    x, a, Bm, Cm = (torch.as_tensor(v) for v in ssd_inputs(_cfg(1, 8), 32,
                                                             4, False))
    y_full, _ = tssm.ssd_chunked(x, a, Bm, Cm, cfg)
    h = 16
    y1, s1 = tssm.ssd_chunked(x[:, :h], a[:, :h], Bm[:, :h], Cm[:, :h], cfg)
    y2, _ = tssm.ssd_chunked(x[:, h:], a[:, h:], Bm[:, h:], Cm[:, h:], cfg,
                             init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_apply_and_grads_match_jax(groups):
    """`mamba_apply` on JAX's weights: the output and the gradient of
    ``sum(y·r)`` with respect to the input and every parameter (A_log, D,
    dt_bias f32 among them)."""
    cfg = _cfg(groups, 8)
    jp = jssm.mamba_init(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    assert [tuple(v.shape) for v in convert.leaves(tp)] == [
        tuple(v.shape) for v in convert.leaves(
            tssm.mamba_init(torch.Generator().manual_seed(0),
                            port_cfg(cfg), torch.float32))]
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    r = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        lambda p, xx: (jnp.sum(jssm.mamba_apply(p, xx, cfg) * r),
                       jssm.mamba_apply(p, xx, cfg)),
        argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    leaves = [v.clone().requires_grad_(True) for v in convert.leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_(True)
    ty = tssm.mamba_apply(convert._rebuild(tp, iter(leaves)), tx,
                          port_cfg(cfg))
    close(ty, jy)
    tg = torch.autograd.grad((ty * torch.as_tensor(r)).sum(), leaves + [tx])
    close(tg[-1], jgx)
    jl = jax.tree.leaves(jgp)
    assert len(jl) == len(tg) - 1
    for a, b in zip(tg[:-1], jl):
        close(a, b)


def test_mamba_decode_matches_jax_step_by_step():
    """24 `mamba_decode` steps from `mamba_init_cache`: every output and
    the final conv and state caches within 1e-5 of JAX's; the steps equal
    the port's `mamba_apply` within test_ssm.py's 2e-3."""
    cfg = _cfg(1, 8)
    jp = jssm.mamba_init(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    x = (np.random.default_rng(6).normal(size=(2, 24, cfg.d_model))
         * 0.5).astype(np.float32)
    jc = jssm.mamba_init_cache(cfg, 2, jnp.float32)
    tc = tssm.mamba_init_cache(port_cfg(cfg), 2, torch.float32)
    assert tc["state"].dtype == torch.float32
    outs = []
    with torch.no_grad():
        for t in range(24):
            jy, jc = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                       cfg)
            ty, tc = tssm.mamba_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                       tc, port_cfg(cfg))
            close(ty, jy)
            outs.append(ty[:, 0])
        full = tssm.mamba_apply(tp, torch.as_tensor(x), port_cfg(cfg))
    close(tc["conv"], jc["conv"])
    close(tc["state"], jc["state"])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def moe_case(cf, L, seed=3):
    cfg = dataclasses.replace(MOE, capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, L, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(3, L, cfg.d_model)).astype(np.float32)
    return cfg, jp, tp, x, r


def port_moe(cfg, tp, x, r, aux_weight=0.7):
    """The port's y, aux and the gradients of ``sum(y·r) + w·aux`` with
    respect to the input and every weight (leaf order)."""
    leaves = [v.clone().requires_grad_(True) for v in convert.leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(convert._rebuild(tp, iter(leaves)), tx,
                            port_cfg(cfg))
    g = torch.autograd.grad((y * torch.as_tensor(r)).sum()
                            + aux_weight * aux, [tx] + leaves)
    return y, aux, g


@pytest.mark.parametrize("cf,L", [(4.0, 16), (1.0, 16), (1.0, 1),
                                  (1.25, 7)],
                         ids=["keep-all", "drop", "decode-G1", "ragged"])
def test_moe_apply_and_grads_match_jax(cf, L):
    """y, the Switch aux loss and every gradient within 1e-5 of JAX's.
    At capacity factor 4.0 every assignment is kept; at 1.0 and L = 16
    some overflow their expert and are dropped (checked: C below the
    largest expert load); at L = 1 the B tokens form one group."""
    cfg, jp, tp, x, r = moe_case(cf, L)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, cfg)
        return jnp.sum(y * r) + 0.7 * aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    ty, taux, tg = port_moe(cfg, tp, x, r)
    close(ty, jy)
    close(taux, jaux)
    close(tg[0], jgx)
    jl = jax.tree.leaves(jgp)
    assert len(jl) == len(tg) - 1
    for a, b in zip(tg[1:], jl):
        close(a, b)
    # the dispatch plan this case exercises
    G = 3 if L > 1 else 1
    Tg, k, E = 3 * L // G, cfg.num_experts_per_tok, cfg.num_experts
    C = max(1, int(np.ceil(Tg * k / E * cf)))
    with torch.no_grad():
        logits = torch.as_tensor(x).reshape(G, Tg, -1) @ tp["router"]
        top_e = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                           stable=True)[1][..., :k]
        load = max(int(torch.bincount(top_e[g].reshape(-1),
                                      minlength=E).max()) for g in range(G))
        _, kept, _, filled = tmoe._routing(top_e, E, C, k)
    assert int(kept.sum()) == int(filled.sum())
    if cf == 4.0:
        assert load <= C and bool(kept.all()), (load, C)
    if (cf, L) == (1.0, 16):
        assert load > C and not bool(kept.all()), (load, C)


def test_moe_gradients_are_repeatable_and_gather_only():
    """Two gradients of one batch are equal bit for bit, and the backward
    graph holds no scatter-add (its gathers run through `_Route`)."""
    cfg, _, tp, x, r = moe_case(1.0, 16)
    _, _, g1 = port_moe(cfg, tp, x, r)
    _, _, g2 = port_moe(cfg, tp, x, r)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, port_cfg(cfg))
    seen, todo = set(), [y.grad_fn, aux.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    names = {type(f).__name__ for f in seen}
    assert "_RouteBackward" in names
    assert not any(n.startswith(("Index", "Gather", "Scatter"))
                   for n in names), names


def test_top_k_takes_the_lower_index_on_ties():
    """Equal router probabilities: lax.top_k's choice (the lower expert
    index first), and the same routing as JAX's."""
    cfg = dataclasses.replace(MOE, capacity_factor=4.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))  # all probs 1/E
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).normal(size=(2, 8, cfg.d_model)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    with torch.no_grad():
        ty, taux = tmoe.moe_apply(tp, torch.as_tensor(x), port_cfg(cfg))
    close(ty, jy)
    close(taux, jaux)
    _, top_e = jax.lax.top_k(jnp.full((4,), 0.25), 2)
    assert list(np.asarray(top_e)) == [0, 1]
