"""The port's models (`repro_torch.models`) against the JAX package's on the
same weights (a JAX ``build_model(cfg).init`` tree carried across by
`repro_torch.convert.params_from_jax`) and the same tokens, for
tests/test_models.py's SSM, HYBRID (mamba + the shared attention block)
and MOE configurations (MOE with a router aux weight, so that the loss's
aux term counts, and arctic's dense residual beside it) and
test_encdec_forward_and_decode's encoder-decoder:

  * `forward`'s logits and aux, `loss_fn` (its router term included) and
    every gradient leaf within 1e-5·max(1, max|JAX|);
  * `prefill`'s last logits and K/V, and 24 `decode_step`s from
    `init_cache` within 1e-5 of JAX's own (logits and every cache leaf);
  * the port's decode equal to its forward within 3e-3 (the JAX test's
    tolerance) for the decoder-only ones;
  * ROADMAP C13: the encoder-decoder's decode reads `cache["cross"]`,
    which `init_cache` zero-fills and nothing fills, so decode ignores the
    encoder in both packages: the port's decode equals JAX's, and neither
    the source frames nor the cross-attention's weights change it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MAMBA, SHARED_ATTN, ModelConfig  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from test_torch_models import close, port_cfg, port_loss_and_grads  # noqa: E402

torch.set_num_threads(1)

SSM = ModelConfig(name="ssm", family="ssm", num_layers=2, d_model=64,
                  num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=97,
                  head_dim=1, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
HYBRID = ModelConfig(name="hyb", family="hybrid", num_layers=6, d_model=64,
                     num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=97,
                     head_dim=16, stages=(((MAMBA, MAMBA, SHARED_ATTN), 2),),
                     window_size=8, ssm_state=16, ssm_head_dim=16,
                     ssm_chunk=8)
MOE = ModelConfig(name="moe", family="moe", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                  head_dim=16, num_experts=4, num_experts_per_tok=2,
                  moe_d_ff=64, capacity_factor=4.0, router_aux_weight=0.01)
ARCTIC = dataclasses.replace(MOE, name="moe-dense", dense_residual=True,
                             capacity_factor=1.25)
ENCDEC = ModelConfig(name="encdec", family="audio", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=97,
                     head_dim=16, is_encoder_decoder=True,
                     num_encoder_layers=2, frontend="audio",
                     encoder_frames_ratio=4)
CFGS = [SSM, HYBRID, MOE, ARCTIC, ENCDEC]
DECODERS = [SSM, HYBRID, MOE]
B, L = 2, 24


@functools.lru_cache(maxsize=None)
def models(cfg):
    """(JAX model, JAX params, port model, port params)."""
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(port_cfg(cfg))
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def batch_of(cfg, seed=1):
    """(JAX batch, port batch) of numpy draws: tokens and targets, and for
    the encoder-decoder the source frames (L / 4 of them)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        b["audio_embeds"] = (rng.normal(size=(
            B, L // cfg.encoder_frames_ratio, cfg.d_model)) * 0.1
        ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_forward_loss_and_grads_match_jax(cfg):
    jm, jp, tm, tp = models(cfg)
    jb, tb = batch_of(cfg)
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    with torch.no_grad():
        tl, taux = tm.forward(tp, tb)
    assert tl.shape == (B, L, cfg.vocab_size)
    close(tl, jl)
    if cfg.is_moe:
        assert float(jaux) > 0
        close(taux, jaux)
    else:
        assert taux == 0.0 and float(jaux) == 0.0
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)
    tloss, tg = port_loss_and_grads(tm, tp, tb)
    close(tloss, jloss)
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for a, b in zip(tg, jleaves):
        close(a, b)


def test_loss_carries_the_router_term():
    """`loss_fn` = cross-entropy + router_aux_weight × aux, as JAX's."""
    _, _, tm, tp = models(MOE)
    _, tb = batch_of(MOE)
    with torch.no_grad():
        logits, aux = tm.forward(tp, tb)
        plain = tbuild(port_cfg(dataclasses.replace(
            MOE, router_aux_weight=0.0))).loss_fn(tp, tb)
        assert float(tm.loss_fn(tp, tb) - plain) == pytest.approx(
            0.01 * float(aux), rel=1e-4)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_prefill_and_decode_match_jax(cfg):
    """Prefill on the batch (last logits, the attention layers' K/V), then
    24 decode steps from `init_cache` (the mamba layers' conv and state
    caches, the shared block's windowed ring, the encoder-decoder's
    zero cross cache): logits and every cache leaf within 1e-5 of JAX's."""
    jm, jp, tm, tp = models(cfg)
    jb, tb = batch_of(cfg)
    jlast, jcaches = jax.jit(jm.prefill)(jp, jb)
    with torch.no_grad():
        tlast, tcaches = tm.prefill(tp, tb)
    close(tlast, jlast)
    tleaves = [x for x in convert.leaves(tcaches) if x is not None]
    jleaves = jax.tree.leaves(jcaches)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        close(a, b)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, L)
                                             ).astype(np.int32)
    jc, tc = jm.init_cache(B, L), tm.init_cache(B, L, device="cpu")
    assert [tuple(x.shape) for x in convert.leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    jstep = jax.jit(jm.decode_step)
    for t in range(L):
        jlg, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        with torch.no_grad():
            tlg, tc = tm.decode_step(tp, tc, torch.as_tensor(toks[:, t]), t)
        close(tlg, jlg)
    for a, b in zip(convert.leaves(tc), jax.tree.leaves(jc)):
        close(a, b)


@pytest.mark.parametrize("cfg", DECODERS, ids=lambda c: c.name)
def test_decode_matches_forward(cfg):
    """tests/test_models.py::test_decode_matches_forward on the port, the
    decode position a 0-d tensor."""
    _, _, tm, tp = models(cfg)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32))
    with torch.no_grad():
        logits, _ = tm.forward(tp, {"tokens": toks})
        cache = tm.init_cache(B, L, device="cpu")
        outs = []
        for t in range(L):
            lg, cache = tm.decode_step(tp, cache, toks[:, t],
                                       torch.tensor(t, dtype=torch.int32))
            outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits.numpy(),
                               rtol=3e-3, atol=3e-3)


def test_encdec_decode_ignores_the_encoder_as_jax_does():
    """ROADMAP C13. JAX's `init_cache` zero-fills ``cache["cross"]`` ("filled
    at prefill") and `prefill` returns only the self-attention caches, so
    `decode_step` attends over zero K/V: uniform weights over zeros, a
    cross term of exactly 0. The port copies it: its decode equals JAX's
    (test_prefill_and_decode_match_jax), the cross cache comes back
    untouched, and decode is the same bit for bit whatever the
    cross-attention's weights, in both packages — while the forward pass,
    which runs the encoder, does depend on them."""
    jm, jp, tm, tp = models(ENCDEC)
    _, tb = batch_of(ENCDEC)
    rng = np.random.default_rng(11)

    def moved(params):
        return convert.tree_map(lambda x: x + torch.as_tensor(
            rng.normal(size=tuple(x.shape)).astype(np.float32)), params)
    other = dict(tp, stages=[tuple(dict(blk, cross=moved(blk["cross"]))
                                   for blk in st) for st in tp["stages"]])
    toks = tb["tokens"]
    with torch.no_grad():
        caches = [tm.init_cache(B, L, device="cpu") for _ in range(2)]
        for t in range(4):
            outs = []
            for i, params in enumerate((tp, other)):
                lg, caches[i] = tm.decode_step(params, caches[i],
                                               toks[:, t], t)
                outs.append(lg)
            assert torch.equal(outs[0], outs[1])
        assert not any(bool(x.any()) for x in
                       convert.leaves(caches[0]["cross"]))
        f0, _ = tm.forward(tp, tb)
        f1, _ = tm.forward(other, tb)
    assert float((f0 - f1).abs().max()) > 1e-2
    # JAX's decode: the same on both weights, and the port's
    jother = jax.tree.map(jnp.asarray, convert.tree_map(lambda x: x.numpy(),
                                                        other))
    jstep = jax.jit(jm.decode_step)
    jc = [jm.init_cache(B, L) for _ in range(2)]
    for t in range(4):
        jl = []
        for i, params in enumerate((jp, jother)):
            lg, jc[i] = jstep(params, jc[i], jnp.asarray(toks[:, t].numpy()),
                              jnp.int32(t))
            jl.append(np.asarray(lg))
        assert np.array_equal(jl[0], jl[1])
    close(outs[0], jl[0])


def test_parameter_structure_is_jaxs():
    """The port's own init builds JAX's tree, leaf for leaf in shape and
    order: the `{}` of a shared_attn entry, `shared_block` and `encoder`
    at model level, the experts' (E, in, out) stacks, the f32 SSM
    vectors."""
    for cfg in CFGS:
        _, jp, tm, _ = models(cfg)
        own = tm.init(torch.Generator().manual_seed(0))
        assert sorted(own) == sorted(jp)
        shapes = [tuple(x.shape) for x in convert.leaves(own)]
        assert shapes == [tuple(x.shape) for x in jax.tree.leaves(jp)]
    own = models(HYBRID)[2].init(torch.Generator().manual_seed(0))
    assert own["stages"][0][2] == {}
    assert own["stages"][0][0]["mamba"]["A_log"].dtype == torch.float32
