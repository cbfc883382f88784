"""The port's models (`repro_torch.models`) against the JAX package's on
the same weights (a JAX ``build_model(cfg).init`` tree carried across by
`repro_torch.convert.params_from_jax`) and the same tokens, for
tests/test_models.py's attention-only configurations — dense GQA,
gemma2-style local/global attention with softcaps, MLA — and a reduced
qwen2-vl (M-RoPE, vision embeds prepended):

  * `forward`'s logits, `loss_fn` and every gradient leaf within
    1e-5·max(1, max|JAX|);
  * `prefill` (its last logits and per-layer K/V) and 24 `decode_step`s
    within 1e-5 of JAX's own;
  * the port's decode equal to its forward within 3e-3 (the JAX test's
    tolerance);
  * ``remat="full"`` and ``"dots"`` equal to ``"none"``, and
    ``scan_layers`` changing nothing.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ATTN, ATTN_LOCAL, ModelConfig  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

torch.set_num_threads(1)

DENSE = ModelConfig(name="dense", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                    head_dim=16)
GEMMA = ModelConfig(name="g2", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                    head_dim=16, stages=(((ATTN_LOCAL, ATTN), 1),),
                    window_size=8, logit_softcap=30.0, attn_softcap=50.0)
MLA = ModelConfig(name="mla", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=97,
                  use_mla=True, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
VLM = jget_config("qwen2-vl-7b").reduced(layers=2, d_model=64, vocab=97)
CFGS = [DENSE, GEMMA, MLA, VLM]
DECODERS = [DENSE, GEMMA, MLA]          # token-only: decode = forward
B, L = 2, 24


def port_cfg(cfg):
    """The same configuration as the port's dataclass."""
    return tbase.ModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def models(cfg):
    """(JAX model, JAX params, port model, port params)."""
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(port_cfg(cfg))
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def batch_of(cfg, seed=1):
    """(JAX batch, port batch) of numpy draws: tokens and targets, and for
    the vlm the vision embeds, the (B, 3, L) position streams (each its
    own offset, so that the M-RoPE sections differ) and ignored targets
    over the patches."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "vision":
        n_p = cfg.num_patches
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, L - n_p))
        b["vision_embeds"] = (rng.normal(size=(B, n_p, cfg.d_model))
                              * 0.1).astype(np.float32)
        b["positions3"] = (np.arange(L)[None, None]
                           + np.array([0, 3, 7])[None, :, None]
                           ).repeat(B, 0)
        tgt = rng.integers(0, cfg.vocab_size, (B, L))
        tgt[:, :n_p] = -1
        b["targets"] = tgt
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, L))
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, L))
    b = {k: (v.astype(np.int32) if v.dtype.kind == "i" else v)
         for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def close(t, j, tol=1e-5):
    j = np.asarray(j)
    t = t.detach().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.max(np.abs(t - j), initial=0.0) <= tol * max(
        1.0, float(np.max(np.abs(j), initial=0.0)))


def port_loss_and_grads(tm, tp, batch, remat="none"):
    xs = [x.clone().requires_grad_(True) for x in convert.leaves(tp)]
    loss = tm.loss_fn(convert._rebuild(tp, iter(xs)), batch, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_forward_loss_and_grads_match_jax(cfg):
    jm, jp, tm, tp = models(cfg)
    jb, tb = batch_of(cfg)
    jl, _ = jm.forward(jp, jb)
    with torch.no_grad():
        tl, _ = tm.forward(tp, tb)
    assert tl.shape == (B, L, cfg.vocab_size)
    close(tl, jl)
    jloss, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tloss, tg = port_loss_and_grads(tm, tp, tb)
    close(tloss, jloss)
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for a, b in zip(tg, jleaves):
        close(a, b)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_prefill_and_decode_match_jax(cfg):
    """Prefill on the whole batch, then 24 decode steps from an empty cache
    on the token stream: logits and caches within 1e-5 of JAX's."""
    jm, jp, tm, tp = models(cfg)
    jb, tb = batch_of(cfg)
    jlast, jcaches = jm.prefill(jp, jb)
    with torch.no_grad():
        tlast, tcaches = tm.prefill(tp, tb)
    close(tlast, jlast)
    # an MLA block keeps no prefill cache (None, which JAX's leaves drop)
    tleaves = [x for x in convert.leaves(tcaches) if x is not None]
    jleaves = jax.tree.leaves(jcaches)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        close(a, b)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, L)
                                             ).astype(np.int32)
    jc, tc = jm.init_cache(B, L), tm.init_cache(B, L, device="cpu")
    for t in range(L):
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                 jnp.int32(t))
        with torch.no_grad():
            tlg, tc = tm.decode_step(tp, tc, torch.as_tensor(toks[:, t]), t)
        close(tlg, jlg)
    for a, b in zip(convert.leaves(tc), jax.tree.leaves(jc)):
        close(a, b)


@pytest.mark.parametrize("cfg", DECODERS, ids=lambda c: c.name)
def test_decode_matches_forward(cfg):
    """tests/test_models.py::test_decode_matches_forward on the port, with
    the decode position a 0-d tensor."""
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


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("cfg", [DENSE, MLA], ids=lambda c: c.name)
def test_remat_matches_no_remat(cfg, remat):
    """Recomputing a layer in the backward pass gives the same loss and
    gradients, bit for bit."""
    _, _, tm, tp = models(cfg)
    _, tb = batch_of(cfg)
    l0, g0 = port_loss_and_grads(tm, tp, tb, "none")
    l1, g1 = port_loss_and_grads(tm, tp, tb, remat)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_refuses_an_unknown_policy():
    _, _, tm, tp = models(DENSE)
    _, tb = batch_of(DENSE)
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(tp, tb, remat="offload")


def test_scan_vs_unrolled_layers():
    _, _, tm, tp = models(DENSE)
    m2 = tbuild(port_cfg(dataclasses.replace(DENSE, scan_layers=False)))
    toks = {"tokens": torch.ones((2, 16), dtype=torch.int32)}
    with torch.no_grad():
        assert torch.equal(tm.forward(tp, toks)[0], m2.forward(tp, toks)[0])


def test_parameter_structure_is_jaxs():
    """A stage is a tuple (one entry per pattern kind) of dicts whose leaves
    lead with the repeats; the leaves come in JAX's order and shapes, for
    the port's own init too."""
    for cfg in CFGS:
        _, jp, tm, _ = models(cfg)
        own = tm.init(torch.Generator().manual_seed(0))
        assert isinstance(own["stages"], list)
        assert all(isinstance(s, tuple) for s in own["stages"])
        shapes = [tuple(x.shape) for x in convert.leaves(own)]
        assert shapes == [tuple(x.shape) for x in jax.tree.leaves(jp)]


def test_init_draws_from_its_generator():
    """The same seed gives the same weights, another seed others; biases
    and norms start at 0, matrices within ±2 standard deviations."""
    _, _, tm, _ = models(DENSE)
    a = tm.init(torch.Generator().manual_seed(3))
    b = tm.init(torch.Generator().manual_seed(3))
    c = tm.init(torch.Generator().manual_seed(4))
    la, lb, lc = (convert.leaves(x) for x in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[0], lc[0])
    emb = a["embed"]["embedding"]
    assert float(emb.abs().max()) <= 2.0 / np.sqrt(DENSE.vocab_size) + 1e-7
    assert not bool(a["final_norm"].any())
