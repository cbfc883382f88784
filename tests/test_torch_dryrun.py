"""The port's dry run over fake tensors (`repro_torch.launch.dryrun`)
against the JAX package's (`repro.launch.dryrun`) on the CPU.

  * For all ten archs, every shape each supports and both production
    meshes, ``spec_argument_bytes_per_rank`` equals, byte for byte, the
    per-rank bytes of JAX's own ``infer_*_shardings`` over `jax.eval_shape`
    trees on an `AbstractMesh` (the arguments JAX's dry run lowers).
  * `_with_reps` agrees with JAX's field for field.
  * On reduced configs the probes' extrapolation equals a direct
    FlopCounterMode count at full depth (train, prefill and decode; a
    two-stage hybrid and an encoder-decoder).
  * The traced train step's FLOPs lie within 0.9–3.5× of 6·N·D for
    train_4k, as tests/test_launch.py asks of the analytic count.
  * The collective counter counts real collectives by JAX's byte formulas,
    and the port's traced steps issue none.
  * The CLI writes one JSON line per combination.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.distributed import make_afl_train_step as jstep  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.sharding import auto as jauto  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

torch.set_num_threads(1)

MESHES = {"single": dryrun.production_mesh(False),
          "multi": dryrun.production_mesh(True)}
COMBOS = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES
          if jreg.supports_shape(a, s)]


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_rank_bytes(tree, shardings):
    """Per-rank bytes of `tree`'s leaves under their NamedShardings."""
    sizes = jax.tree.leaves(jax.tree.map(
        lambda x, s: int(np.prod(s.shard_shape(x.shape), dtype=np.int64))
        * jnp.dtype(x.dtype).itemsize, tree, shardings))
    return sum(sizes)


def _jax_arguments(arch, shape, mesh):
    """JAX's dry-run arguments (`lower_train` / `lower_prefill` /
    `lower_decode`'s) as eval_shape trees with their shardings -> bytes
    per rank."""
    cfg = jreg.get_config(arch, shape=shape.name, dtype="bfloat16")
    model = jbuild(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rep = NamedSharding(mesh, P())
    if shape.mode == "train":
        init_fn, _ = jstep(lambda p, b: model.loss_fn(p, b),
                           jreg.afl_config(arch, algorithm="ace"),
                           jsgd(0.01))
        state = jax.eval_shape(init_fn, params)
        batch = jreg.input_specs(cfg, shape)["batch"]
        state_sh = type(state)(
            params=jauto.infer_params_shardings(state.params, mesh,
                                                fsdp=True),
            opt_state=jauto.infer_opt_shardings(state.opt_state, mesh),
            afl=jauto.infer_afl_shardings(state.afl, mesh), step=rep)
        return (_jax_rank_bytes(state, state_sh) + _jax_rank_bytes(
            batch, jauto.infer_batch_shardings(batch, mesh)) + 2 * 4)
    if shape.mode == "prefill":
        batch = jreg.input_specs(cfg, shape)["batch"]
        return (_jax_rank_bytes(params,
                                jauto.infer_params_shardings(params, mesh))
                + _jax_rank_bytes(batch,
                                  jauto.infer_batch_shardings(batch, mesh)))
    specs = jreg.input_specs(cfg, shape)
    cache_sh = jauto.infer_decode_cache_shardings(specs["cache"], mesh,
                                                  shape.global_batch)
    return (_jax_rank_bytes(params, jauto.infer_params_shardings(params,
                                                                 mesh))
            + _jax_rank_bytes(specs["cache"], cache_sh)
            + _jax_rank_bytes(specs["tokens"], jauto.infer_batch_shardings(
                specs["tokens"], mesh)) + 4)


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_spec_bytes_per_rank_equal_jax(arch, shape):
    """Both production meshes: the port's per-rank argument bytes under the
    specs equal JAX's exactly, and the port holds more than that per rank
    (everything whole)."""
    sh = INPUT_SHAPES[shape]
    for sizes in MESHES.values():
        spec_b, held_b, _ = dryrun.argument_bytes(arch, sh, sizes)
        assert spec_b == _jax_arguments(arch, sh, _abstract(sizes))
        assert held_b >= spec_b


@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX's dry-run module. Importing it sets XLA_FLAGS for 512 host
    devices; this process's backend is up first (so the flag cannot
    reach it) and the variable is restored after."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdry


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_with_reps_matches_jax(arch, jax_dryrun):
    tcfg = get_config(arch, dtype="bfloat16")
    jcfg = jreg.get_config(arch, dtype="bfloat16")
    n = len(tcfg.stages)
    cases = [([1] * n, 1), ([1] * n, 2)] + [
        ([2 if i == s else 1 for i in range(n)], 1) for s in range(n)] + [
        ([r for _, r in tcfg.stages], 0)]
    for reps, enc in cases:
        got = dataclasses.asdict(dryrun._with_reps(tcfg, reps, enc))
        want = dataclasses.asdict(jax_dryrun._with_reps(jcfg, reps, enc))
        assert got == want


SMALL = {"train": InputShape("small_train", 64, 2, "train"),
         "prefill": InputShape("small_prefill", 96, 2, "prefill"),
         "decode": InputShape("small_decode", 64, 2, "decode")}


@pytest.mark.parametrize("arch,reps,enc,mode", [
    ("yi-9b", (3,), 0, "train"),
    ("zamba2-1.2b", (3, 2), 0, "decode"),
    ("seamless-m4t-medium", (3,), 3, "train"),
    ("gemma2-2b", (4,), 0, "prefill")])
def test_probe_extrapolation_equals_full_depth(arch, reps, enc, mode):
    """On a reduced config cut to `reps` repeats a stage (and `enc`
    encoder layers), the probes' extrapolated FLOPs equal a direct
    FlopCounterMode count of the full-depth step."""
    full = dryrun._with_reps(get_config(arch).reduced(d_model=64, vocab=96),
                             list(reps), enc)
    shape = SMALL[mode]
    probe = dryrun.probe_costs(arch, shape, None, cfg=full, remat="full")
    direct = dryrun._trace(arch, shape, None, full, "ace", "full")
    assert direct["flops"] > 0
    assert probe["flops"] == direct["flops"]
    assert probe["coll_bytes"] == direct["coll_bytes"] == 0


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-780m"])
def test_train_flops_sane(arch):
    """The traced train_4k step (full remat), extrapolated to full depth,
    lies between 0.9× and 3.5× of 6·N_active·D."""
    cfg = get_config(arch, dtype="bfloat16")
    shape = INPUT_SHAPES["train_4k"]
    probe = dryrun.probe_costs(arch, shape, MESHES["single"], remat="full")
    model_flops = 6 * cfg.active_param_count() * shape.global_batch \
        * shape.seq_len
    assert 0.9 * model_flops < probe["flops"] < 3.5 * model_flops
    assert probe["coll_bytes"] == 0.0
    assert probe["peak_bytes"] > dryrun.CARD_BYTES    # the whole batch


def test_collective_counter_and_none_in_the_port():
    """Collectives issued under a fake world of 4 ranks are counted by
    JAX's formulas (all-reduce 2 × size, all-gather the result,
    reduce-scatter result × k); the port's traced train, prefill and
    decode issue none under the production mesh."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    with dryrun.fake_world(4):
        with dryrun._comm_mode() as comm:
            x = torch.ones(8)
            dist.all_reduce(x)
            out = torch.empty(32)
            dist.all_gather_into_tensor(out, x)
            dist.reduce_scatter_tensor(torch.empty(8), out)
        with dryrun._comm_mode() as func:
            world = dist.group.WORLD
            outs = [funcol.all_reduce(x, "sum", world),
                    funcol.all_gather_tensor(x, 0, world),
                    funcol.reduce_scatter_tensor(out, "sum", 0, world)]
            assert [(o + 0).numel() for o in outs] == [8, 32, 8]
        for c in (comm, func):      # c10d's and the functional forms
            assert c.get_total_counts() == 3
            assert c.bytes["all-reduce"] == 2 * 32
            assert c.bytes["all-gather"] == 128
            assert c.bytes["reduce-scatter"] == 128
    assert not dist.is_initialized()
    cfg = get_config("yi-9b").reduced(d_model=64, vocab=96)
    mesh = MESHES["single"]
    with dryrun.fake_world(256):
        for mode in ("train", "prefill", "decode"):
            rec = dryrun._trace("yi-9b", SMALL[mode], mesh, cfg, "ace",
                                "full")
            assert rec["coll_counts"] == 0 and rec["coll_bytes"] == 0.0


def test_traces_leave_no_fake_tensor_behind():
    """A traced step makes the rules' cached constants afresh: after two
    traces in one process the cache holds only real tensors, and a real
    step runs."""
    from repro_torch.core import aggregators as tagg
    from repro_torch.core.distributed import make_afl_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    cfg = get_config("yi-9b").reduced(d_model=64, vocab=96)
    for _ in range(2):
        dryrun._trace("yi-9b", SMALL["train"], None, cfg, "ace", "none")
    fakes = [t for t in tagg._CONSTANTS.values()
            if type(t).__name__ == "FakeTensor"]
    assert fakes == []
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    init_fn, step_fn = make_afl_train_step(
        model.loss_fn, jreg.afl_config("yi-9b", algorithm="ace"), sgd(0.01))
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "targets": torch.zeros((2, 8), dtype=torch.int32)}
    _, m = step_fn(init_fn(params), batch, 0, torch.tensor(0))
    assert bool(torch.isfinite(m["loss"]))


def test_meta_params_match_a_real_init():
    """`_MetaGenerator` gives `model.init`'s structure, shapes and dtypes
    without drawing anything."""
    from repro_torch.convert import leaves
    from repro_torch.models import build_model
    for arch in ("zamba2-1.2b", "minicpm3-4b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch).reduced(d_model=64, vocab=96)
        meta = dryrun.meta_params(cfg)
        real = build_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
        assert [(tuple(a.shape), a.dtype, a.device.type)
                for a in leaves(meta)] == [
            (tuple(b.shape), b.dtype, "meta") for b in leaves(real)]


def test_cli_writes_one_line_per_combination(tmp_path):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "gemma2-2b,yi-9b", "--shape",
                 "decode_32k,long_500k", "--both-meshes", "--no-probes",
                 "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 8
    assert not [r for r in recs if "error" in r]
    skipped = [(r["arch"], r["shape"]) for r in recs if r.get("skipped")]
    assert skipped == [("yi-9b", "long_500k")] * 2
    done = [r for r in recs if not r.get("skipped")]
    for r in done:
        assert r["chips"] == (512 if r["multi_pod"] else 256)
        assert r["held_argument_bytes_per_rank"] > \
            r["spec_argument_bytes_per_rank"]
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["fits_one_card"] == (
            r["held_argument_bytes_per_rank"] <= dryrun.CARD_BYTES)
    dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                 "--out", str(out)])
    last = json.loads(out.read_text().splitlines()[-1])
    assert last["probe_coll_per_rank"] == 0.0
    assert last["peak_bytes_per_rank"] >= last["held_argument_bytes_per_rank"]
    assert last["probe_flops_per_rank"] > 0
