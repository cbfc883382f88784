"""The port's entry points (`repro_torch.launch`) against the JAX package's
`repro.launch`, on the CPU:

  * `analytic_costs`, `forward_flops` and `decode_flops` equal to JAX's for
    the ten archs × the four input shapes × remat × the AFL rules, and
    tests/test_launch.py's three analytic tests on the port;
  * the train driver's options and defaults: JAX's, plus ``--device``; one
    visible device runs unsharded, more raise;
  * serving: the prompts are JAX's draw, and `generate` on JAX's weights
    (`convert.params_from_jax`) gives JAX `serve.main`'s first tokens and
    the last prompt step's logits within 1e-4 of JAX's decode loop, for
    reduced gemma2, minicpm3, mamba2 and zamba2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AFLConfig as JAFLConfig  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, AFLConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.analytic import (analytic_costs,  # noqa: E402
                                         decode_flops, forward_flops)
from repro_torch.launch.serve import generate, make_prompts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

AFL_RULES = ("ace", "ace_direct", "aced", "ca2fl", "fedbuff", "asgd")


def test_the_archs_and_shapes_are_jaxs():
    assert sorted(ARCHS) == sorted(J_ARCHS) and len(ARCHS) == 10
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES) and len(INPUT_SHAPES) == 4


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_analytic_counts_equal_jaxs(arch):
    for shape_name in sorted(J_SHAPES):
        for shape_cfg in (None, shape_name):
            cfg = get_config(arch, shape=shape_cfg)
            jcfg = jget_config(arch, shape=shape_cfg)
            shape, jshape = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
            B, L = shape.global_batch, shape.seq_len
            assert forward_flops(cfg, B, L) == janalytic.forward_flops(
                jcfg, B, L)
            assert decode_flops(cfg, B, L) == janalytic.decode_flops(
                jcfg, B, L)
            for remat in ("none", "dots", "full"):
                assert analytic_costs(cfg, shape, remat=remat) == \
                    janalytic.analytic_costs(jcfg, jshape, remat=remat)
                for algo in AFL_RULES:
                    for cd in ("float32", "int8"):
                        kw = dict(algorithm=algo, n_clients=16,
                                  cache_dtype=cd, state_dtype="bfloat16")
                        got = analytic_costs(cfg, shape, remat=remat,
                                             afl=AFLConfig(**kw))
                        assert got == janalytic.analytic_costs(
                            jcfg, jshape, remat=remat, afl=JAFLConfig(**kw))
                        assert set(got) == {"flops", "bytes"}


@pytest.mark.parametrize("arch", ["yi-9b", "qwen3-moe-235b-a22b",
                                  "mamba2-780m", "llama3-405b"])
def test_analytic_flops_sane(arch):
    cfg = get_config(arch, dtype="bfloat16")
    shape = INPUT_SHAPES["train_4k"]
    costs = analytic_costs(cfg, shape, remat="full")
    tokens = shape.global_batch * shape.seq_len
    model_flops = 6 * cfg.active_param_count() * tokens
    assert costs["flops"] > model_flops * 0.9
    assert costs["flops"] < model_flops * 3.5
    assert costs["bytes"] > cfg.param_count()


def test_decode_flops_scale_with_cache_depth():
    cfg = get_config("yi-9b", dtype="bfloat16")
    f32k = decode_flops(cfg, 128, 32768)
    f16k = decode_flops(cfg, 128, 16384)
    assert f32k > f16k
    assert f32k > 2 * cfg.param_count() * 128


def test_window_reduces_analytic_attention():
    full = get_config("gemma2-2b")
    swa = get_config("gemma2-2b", shape="long_500k")
    B, L = 1, 32768
    assert forward_flops(swa, B, L) < forward_flops(full, B, L)


# ---------------------------------------------------------------------------
# the train driver's options
# ---------------------------------------------------------------------------

def test_train_parser_defaults_are_jaxs():
    ours = vars(ttrain._parser().parse_args([]))
    theirs = vars(jtrain._parser().parse_args([]))
    assert ours == {**theirs, "device": None}
    assert set(ours) - set(theirs) == {"device"}
    for action in jtrain._parser()._actions:
        if action.choices:
            mine = next(a for a in ttrain._parser()._actions
                        if a.dest == action.dest)
            assert tuple(mine.choices) == tuple(action.choices)


def test_train_rejects_unknown_options():
    with pytest.raises(TypeError, match="unknown train option"):
        ttrain.train(no_such_option=1)


def test_mesh_auto_runs_unsharded_on_one_device(monkeypatch):
    """Without a process group, ``--mesh auto`` runs unsharded on one
    visible device and raises, naming torchrun, on more."""
    assert ttrain._mesh("auto", torch.device("cpu")) is None
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ttrain._mesh("auto", cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        ttrain._mesh("auto", cuda)
    assert ttrain._mesh("none", cuda) is None


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,B,P", [(0, 256000, 4, 64), (3, 512, 2, 8),
                                            (11, 100, 3, 5)])
def test_prompts_are_jaxs(seed, vocab, B, P):
    """`repro.launch.serve.main`'s draw: ``default_rng(seed).integers(0,
    vocab, (B, P))`` as int32."""
    rng = np.random.default_rng(seed)
    want = np.asarray(jnp.asarray(rng.integers(0, vocab, size=(B, P)),
                                  jnp.int32))
    got = make_prompts(vocab, B, P, seed, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


SERVE = dict(batch=2, prompt_len=8, gen=4, seed=0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "minicpm3-4b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_generate_matches_jax_serve(arch):
    B, P, G, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen",
                                        "seed"))
    jcfg = jget_config(arch).reduced()
    jgen = jserve.main(["--arch", arch, "--reduced", "--batch", str(B),
                        "--prompt-len", str(P), "--gen", str(G),
                        "--seed", str(seed)])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    prompts = make_prompts(jcfg.vocab_size, B, P, seed, "cpu")
    decode = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(B, P + G)
    jp = jnp.asarray(prompts.numpy())
    for t in range(P):
        jlogits, cache = decode(jparams, cache, jp[:, t], jnp.int32(t))

    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    gen = torch.Generator().manual_seed(seed)
    tokens, last = generate(model, params, prompts, G, 0.8, gen)
    assert tokens.shape == (B, G) and tokens.dtype == torch.int32
    assert bool(((tokens >= 0) & (tokens < jcfg.vocab_size)).all())
    np.testing.assert_allclose(last.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(tokens[:, 0].numpy(), jgen[:, 0])
    # the same generator seed gives the same tokens
    again, _ = generate(model, params, prompts, G, 0.8,
                        torch.Generator().manual_seed(seed))
    assert torch.equal(again, tokens)
