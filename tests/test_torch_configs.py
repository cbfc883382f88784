"""The port's configurations (`repro_torch.configs`) against the JAX
package's: all ten architectures and their ``reduced()`` variants field by
field, the analytic parameter counts, the registry's lookups and sizing,
the input specs (meta-device stand-ins against ``ShapeDtypeStruct``s) and
the materialized batches; then every architecture's reduced model run forward
and decoded, and a JAX init of each carried across and run."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import gemma2_2b as jgemma  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import gemma2_2b as tgemma  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

ARCHS = list(jreg.ARCHS)
# every architecture builds in the port
BUILDABLE = ARCHS
SMOKE = tbase.InputShape("smoke", 64, 2, "train")


def test_the_registry_lists_the_same_archs():
    assert list(treg.ARCHS) == ARCHS
    assert treg.LONG_CONTEXT_OK == jreg.LONG_CONTEXT_OK
    assert treg.AFL_SIZING == jreg.AFL_SIZING


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_field_by_field(arch):
    j, t = jreg.ARCHS[arch], treg.ARCHS[arch]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for kw in ({}, dict(layers=2, d_model=64, vocab=128),
               dict(layers=5, d_model=128, experts=2, vocab=97)):
        assert dataclasses.asdict(t.reduced(**kw)) == \
            dataclasses.asdict(j.reduced(**kw))
    for c_t, c_j in ((t, j), (t.reduced(), j.reduced())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        assert (c_t.is_moe, c_t.attention_free, c_t.sub_quadratic,
                c_t.d_inner, c_t.ssm_heads) == \
            (c_j.is_moe, c_j.attention_free, c_j.sub_quadratic, c_j.d_inner,
             c_j.ssm_heads)


def test_dataclass_defaults_and_shapes_match():
    for name in ("ModelConfig", "InputShape", "AFLConfig"):
        jf = {f.name: f.default for f in
              dataclasses.fields(getattr(jbase, name))}
        tf = {f.name: f.default for f in
              dataclasses.fields(getattr(tbase, name))}
        assert tf == jf, name
    assert {k: dataclasses.asdict(v) for k, v in
            tbase.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    assert (tbase.ATTN, tbase.ATTN_LOCAL, tbase.MAMBA, tbase.SHARED_ATTN) == \
        (jbase.ATTN, jbase.ATTN_LOCAL, jbase.MAMBA, jbase.SHARED_ATTN)
    assert dataclasses.asdict(tgemma.swa_variant()) == \
        dataclasses.asdict(jgemma.swa_variant())


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_lookups_match(arch):
    for shape in list(jbase.INPUT_SHAPES) + [None]:
        assert dataclasses.asdict(treg.get_config(arch, shape=shape)) == \
            dataclasses.asdict(jreg.get_config(arch, shape=shape))
        if shape is not None:
            assert treg.supports_shape(arch, shape) == \
                jreg.supports_shape(arch, shape)
            assert treg.skip_reason(arch, shape) == \
                jreg.skip_reason(arch, shape)
    assert dataclasses.asdict(treg.get_config(arch, dtype="bfloat16")) == \
        dataclasses.asdict(jreg.get_config(arch, dtype="bfloat16"))
    for over in ({}, dict(n_clients=4), dict(algorithm="aced", k_batch=3)):
        assert dataclasses.asdict(treg.afl_config(arch, **over)) == \
            dataclasses.asdict(jreg.afl_config(arch, **over))
    cfg = treg.get_config("gemma2-2b", shape="long_500k")
    assert cfg.name == "gemma2-2b-swa" and cfg.sub_quadratic


def _spec_leaves(specs, meta):
    if meta:
        return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for x in convert.leaves(specs)]
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch):
    """Shapes and dtypes of every input, leaf for leaf, on the meta device
    (no storage); a decode spec builds the model's cache (the mamba
    layers' conv and state, the shared block's window, the
    encoder-decoder's cross K/V)."""
    for shape in jbase.INPUT_SHAPES.values():
        if not jreg.supports_shape(arch, shape.name):
            continue
        cfg = treg.get_config(arch, shape=shape.name)
        t = treg.input_specs(cfg, shape)
        assert all(x.device.type == "meta" for x in convert.leaves(t))
        j = jreg.input_specs(jreg.get_config(arch, shape=shape.name), shape)
        assert _spec_leaves(t, True) == _spec_leaves(j, False)


@pytest.mark.parametrize("arch", BUILDABLE)
def test_concrete_batch_matches(arch):
    """The same arrays from the same seed, train and decode (the decode
    batch includes its cache's leaves)."""
    cfg_j = jreg.ARCHS[arch].reduced(layers=2, d_model=64, vocab=128)
    cfg_t = treg.ARCHS[arch].reduced(layers=2, d_model=64, vocab=128)
    for shape, override in ((SMOKE, None),
                            (tbase.InputShape("dec", 32, 2, "decode"), None)):
        j = jreg.concrete_batch(cfg_j, jbase.InputShape(**dataclasses.asdict(
            shape)), rng=3, batch_override=override)
        t = treg.concrete_batch(cfg_t, shape, rng=3, batch_override=override,
                                device="cpu")
        jl, tl = jax.tree.leaves(j), convert.leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            b = np.asarray(b)
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            assert np.array_equal(a.numpy(), b)


def _smoke_batch(cfg, L=64, seed=0):
    """tests/test_configs_smoke.py's batch, as tensors."""
    rng = np.random.default_rng(seed)
    Bs = 2
    batch = {}
    if cfg.frontend == "vision":
        n_p = cfg.num_patches
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (Bs, L - n_p)).astype(np.int32))
        batch["vision_embeds"] = torch.as_tensor(
            (rng.normal(size=(Bs, n_p, cfg.d_model)) * 0.1).astype(
                np.float32))
        batch["positions3"] = torch.arange(L, dtype=torch.int32)[
            None, None].expand(Bs, 3, L)
    elif cfg.frontend == "audio":
        batch["audio_embeds"] = torch.as_tensor(
            (rng.normal(size=(Bs, L // cfg.encoder_frames_ratio,
                              cfg.d_model)) * 0.1).astype(np.float32))
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (Bs, L)).astype(np.int32))
    else:
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (Bs, L)).astype(np.int32))
    batch["targets"] = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (Bs, L)).astype(np.int32))
    return batch


@pytest.mark.parametrize("arch", BUILDABLE)
def test_reduced_forward_and_decode(arch):
    """tests/test_configs_smoke.py's forward and decode on the port: logits
    of shape (B, L, vocab), finite; a finite loss; three decode steps
    finite, each fed the argmax of the last."""
    cfg = treg.get_config(arch).reduced()
    assert cfg.d_model <= 512
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _smoke_batch(cfg)
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        Bs, L = batch["targets"].shape
        assert logits.shape == (Bs, L, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert bool(torch.isfinite(model.loss_fn(params, batch)))
        cache = model.init_cache(Bs, 32, device="cpu")
        tok = torch.zeros((Bs,), dtype=torch.int32)
        for t in range(3):
            logits, cache = model.decode_step(params, cache, tok, t)
            assert logits.shape == (Bs, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all()), arch
            tok = torch.argmax(logits, -1).int()


def test_built_tree_is_tied_whatever_the_config_says():
    """ROADMAP C10: both packages build one embedding, unembedding with its
    transpose, even for untied configs, whose `param_count` counts an
    unembedding; the built trees agree leaf for leaf, and the count
    exceeds them by exactly vocab × d_model."""
    cfg_t = treg.get_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
    cfg_j = jreg.get_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
    assert not cfg_t.tie_embeddings
    params = build_model(cfg_t).init(torch.Generator().manual_seed(0))
    numel = sum(x.numel() for x in convert.leaves(params))
    jnumel = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: jbuild(cfg_j).init(jax.random.PRNGKey(0)))))
    assert numel == jnumel
    assert cfg_t.param_count() - numel == cfg_t.vocab_size * cfg_t.d_model
    assert list(params) == ["embed", "final_norm", "stages"]
    assert list(params["embed"]) == ["embedding"]


def test_input_specs_of_a_full_width_decode_allocate_nothing():
    """yi-9b's decode_32k cache (48 layers × 128 × 32,768 positions) as
    meta tensors: shapes only."""
    specs = treg.input_specs(treg.get_config("yi-9b"), "decode_32k")
    k = specs["cache"]["layers"][0][0]["k"]
    assert k.device.type == "meta"
    assert tuple(k.shape) == (48, 128, 32768, 4, 128)
    assert specs["pos"].dtype == torch.int32 and specs["pos"].dim() == 0


@pytest.mark.parametrize("arch", BUILDABLE)
def test_params_from_jax_carries_a_jax_model(arch):
    """`convert.params_from_jax` carries a JAX ``build_model(cfg).init``
    tree across as it is: the stages a list of tuples (one dict per
    pattern kind), every leaf equal, in JAX's leaf order; the port's model
    runs on it."""
    cfg_j = jreg.ARCHS[arch].reduced(layers=2, d_model=64, vocab=97)
    jp = jbuild(cfg_j).init(jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    assert isinstance(tp["stages"], list)
    assert all(isinstance(st, tuple) and len(st) == len(pat)
               for st, (pat, _) in zip(tp["stages"], cfg_j.stages))
    jl, tl = jax.tree.leaves(jp), convert.leaves(tp)
    assert len(jl) == len(tl)
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(tl, jl))
    cfg_t = treg.ARCHS[arch].reduced(layers=2, d_model=64, vocab=97)
    with torch.no_grad():
        logits, _ = build_model(cfg_t).forward(tp, _smoke_batch(cfg_t, L=32))
    assert bool(torch.isfinite(logits).all())
