"""The port's sharding rules (`repro_torch.sharding.rules`, `.auto`) and
mesh constructors (`repro_torch.launch.mesh`) against the JAX package's.

JAX's spec functions take an `AbstractMesh` on one CPU device; the port's
take the same axis sizes (a ``{name: size}`` mapping), so every case runs
without ranks:

  * `logical_to_spec` for every `LOGICAL_RULES` key, on meshes with and
    without ``pod`` and with none;
  * the divisibility guards (`auto._guard`, and `guarded_spec` — the spec
    JAX's `shard` constrains to, which lays out the port's blocked state);
  * `param_spec` over every leaf of the ten archs' ``reduced()``
    parameters, with ``fsdp`` on and off, and `cache_spec` over every leaf
    of their decode caches at B = 1 and B = 4;
  * `shard` / `replicate` hand a plain tensor back, with or without an
    active rule set, and on a DTensor over a fake (2, 2) world redistribute
    it (`use_param` gathers over ``data`` and keeps the ``model`` split);
    the mesh constructors raise where JAX's would refuse;
  * `place.to_placements` on tuple axes (``("pod", "data")``), one-rank
    axes and dims that do not divide, and the kernel wrappers on DTensors:
    rows whole on each rank run on the local shard (the quantizers also on
    rows split over ranks), a row split across ranks raises;
  * on a fake group at a chosen rank, the MoE's expert re-split (each
    rank's experts, their weights whole in d and f) and the SSD's
    re-layout of its in-projection onto the heads (the columns of a rank's
    heads, B and C whole), local shapes and offsets against the specs.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.sharding import auto as jauto  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.registry import get_config as tget_config  # noqa: E402
from repro_torch.core.scan_sharded import staleness_mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.sharding import auto as tauto  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

torch.set_num_threads(1)

MESHES = {"data4_model2": {"data": 4, "model": 2},
          "pod2_data4_model2": {"pod": 2, "data": 4, "model": 2},
          "data1_model1": {"data": 1, "model": 1}}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _spec(p):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


@pytest.mark.parametrize("mesh", [None] + sorted(MESHES))
@pytest.mark.parametrize("key", sorted(trules.LOGICAL_RULES))
def test_logical_to_spec_matches_jax(key, mesh):
    sizes = MESHES.get(mesh)
    jm = _abstract(sizes) if sizes else None
    for axes in ((key,), (key, None, "heads"), (None, key)):
        assert trules.logical_to_spec(axes, mesh=sizes) == _spec(
            jrules.logical_to_spec(axes, mesh=jm))
    # the active rule set and an override, as use_rules gives them
    over = {key: "model"}
    with trules.use_rules(sizes, over), jrules.use_rules(jm, over):
        assert trules.logical_to_spec((key, "batch")) == _spec(
            jrules.logical_to_spec((key, "batch")))


GUARD_CASES = [((8, 6), ("data", "model")), ((7, 6), ("data", "model")),
               ((8, 5), ("data", "model")), ((3, 5), ("data", "model")),
               ((16, 4, 2), (("pod", "data"), "model", None)),
               ((6, 4), (("pod", "data"), None)),
               ((4, 4), ("model", "model"))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(GUARD_CASES)))
def test_guard_matches_jax(case, mesh):
    shape, spec = GUARD_CASES[case]
    sizes = MESHES[mesh]
    assert tauto._guard(sizes, shape, spec) == _spec(
        jauto._guard(_abstract(sizes), shape, spec))


@pytest.mark.parametrize("shape,want", [
    ((8, 6), ("data", "model")), ((7, 6), (None, "model")),
    ((8, 5), ("data", None)), ((7, 5), (None, None))])
def test_guarded_spec_is_shards_constraint(shape, want):
    """The blocked cache's split: `logical_to_spec` of the cache axes
    through `shard`'s guard; a rule override moves it."""
    sizes = MESHES["data4_model2"]
    with trules.use_rules(sizes):
        assert trules.guarded_spec(shape, ("cache_clients", "cache_d")) == want
    with trules.use_rules(sizes, {"cache_d": None}):
        assert trules.guarded_spec(
            shape, ("cache_clients", "cache_d"))[1] is None
    assert trules.guarded_spec(shape, ("cache_clients", "cache_d")) == (
        None, None)


def _jax_paths(tree):
    """{path: leaf} of a JAX tree, its keys as the port's path entries."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(p, "key", getattr(p, "idx", None))
                  for p in path)] = (path, leaf)
    return out


def _torch_specs(tree):
    """{path: spec} of a spec tree the port's `infer_*` built."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, list) or (isinstance(x, tuple) and not all(
                s is None or isinstance(s, (str, tuple)) for s in x)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out[path] = x
    walk(tree, ())
    return out


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def models():
    """Each arch's reduced config: JAX's abstract parameters and the port's
    parameters."""
    out = {}
    for arch in sorted(ARCHS):
        jcfg = jget_config(arch).reduced()
        tcfg = tget_config(arch).reduced()
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        out[arch] = (jm, tm, jp, tp)
    return out


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_matches_jax(arch, fsdp, models):
    _, _, jp, tp = models[arch]
    sizes = MESHES["data4_model2"]
    am = _abstract(sizes)
    want = {k: _spec(jauto.param_spec(p, leaf, am, fsdp=fsdp))
            for k, (p, leaf) in _jax_paths(jp).items()}
    got = _torch_specs(tauto.infer_params_shardings(tp, sizes, fsdp=fsdp))
    assert len(want) == _leaf_count(jp)
    # a 0-d or 1-D leaf's spec is () in both (JAX's P() ≡ P(None))
    got = {k: v for k, v in got.items()}
    assert got == want
    # and something is actually split at these widths
    assert any(any(s is not None for s in v) for v in got.values())


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_spec_matches_jax(arch, batch, models):
    jm, tm, _, _ = models[arch]
    sizes = MESHES["data4_model2"]
    am = _abstract(sizes)
    jc = jax.eval_shape(lambda: jm.init_cache(batch, 16))
    tc = tm.init_cache(batch, 16, device="cpu")
    b_axes = jauto._batch_axes(am)
    sharded = (batch % max(jauto._axis_size(am, b_axes), 1) == 0
               and jauto._axis_size(am, b_axes) > 1)
    want = {k: _spec(jauto.cache_spec(p, leaf, am, sharded))
            for k, (p, leaf) in _jax_paths(jc).items()}
    got = _torch_specs(tauto.infer_decode_cache_shardings(tc, sizes, batch))
    assert got == want


def test_afl_batch_and_opt_specs_match_jax(models):
    """`infer_afl_shardings` over a tree cache and running sum of yi's
    reduced parameters, `infer_batch_shardings` and `infer_opt_shardings`,
    against JAX's (specs of its NamedShardings)."""
    _, _, jp, tp = models["yi-9b"]
    sizes = MESHES["data4_model2"]
    am = _abstract(sizes)
    n = 8

    def jafl(p):
        return {"cache": {"q": jax.tree.map(
            lambda x: jax.ShapeDtypeStruct((n,) + x.shape, jnp.int8), p),
            "scale": jax.ShapeDtypeStruct((n,), jnp.float32)}, "u": p}
    tafl = {"cache": {"q": _tmap(lambda x: torch.zeros(
        (n,) + tuple(x.shape), dtype=torch.int8), tp),
        "scale": torch.zeros(n)}, "u": tp}
    cases = [
        (jauto.infer_afl_shardings(jafl(jp), am),
         tauto.infer_afl_shardings(tafl, sizes)),
        (jauto.infer_opt_shardings({"m": jp, "count": jnp.int32(0)}, am),
         tauto.infer_opt_shardings({"m": tp, "count": torch.tensor(0)},
                                   sizes)),
        (jauto.infer_batch_shardings(
            {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "pos": jnp.int32(0)}, am),
         tauto.infer_batch_shardings(
            {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "pos": torch.tensor(0)}, sizes)),
    ]
    for jtree, ttree in cases:
        want = {k: _spec(s.spec) for k, (_, s) in _jax_paths(jtree).items()}
        assert _torch_specs(ttree) == want


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return fn(tree)


def test_param_spec_fn_matches_jax():
    sizes = MESHES["pod2_data4_model2"]
    tree = {"wq": ("p_embed", "p_heads"), "ln": ("embed",),
            "ffn": {"wi": ("p_embed", "p_mlp"), "b": ("batch", None)}}
    got = trules.param_spec_fn(None, sizes)(tree)
    am = _abstract(sizes)
    want = jax.tree.map(
        lambda axes: _spec(jrules.logical_to_spec(axes, mesh=am)), tree,
        is_leaf=lambda x: isinstance(x, (tuple, list)))
    assert got == want


@pytest.mark.parametrize("mesh", [None, "data4_model2", "placed"])
def test_shard_and_replicate_hand_back_their_argument(mesh):
    """No-ops on a plain tensor without a mesh (JAX's `shard`, `replicate`)
    and under one; a DTensor is redistributed: `shard` to the guarded spec
    of its logical axes (an all-None spec leaves it), `replicate` to every
    rank whole, `use_param` over ``data`` only."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.sharding import place
    x = torch.ones(4, 4)
    if mesh is None:
        assert trules.shard(x, ("batch", None)) is x
        assert trules.replicate(x) is x
        assert trules.use_param(x) is x
        assert jrules.shard(jnp.ones((4, 4)), ("batch", None)).shape == (4, 4)
        return
    if mesh == "placed":
        with fake_world(4):
            m = trules.build_mesh((2, 2), ("data", "model"))
            w = place.distribute(torch.ones(8, 4), ("model", "data"), m)
            assert w.placements == (Shard(1), Shard(0))
            assert trules.use_param(w).placements == (Replicate(), Shard(0))
            assert trules.replicate(w).placements == (Replicate(),) * 2
            h = trules.replicate(w)
            assert trules.shard(h, ("batch", "embed")).placements == (
                Shard(0), Replicate())
            assert trules.shard(h, ("seq", None)) is h
            # 3 does not divide over data: that dim stays whole
            odd = place.distribute(torch.ones(3, 4), (), m)
            assert trules.shard(odd, ("batch", "embed")) is odd
        return
    with trules.use_rules(MESHES[mesh]):
        assert trules.active_mesh() == MESHES[mesh]
        assert trules.shard(x, ("batch", "embed")) is x
        assert trules.replicate(x) is x
    assert trules.active_mesh() is None


def test_to_placements_tuple_axes_and_guard():
    """A dim over ``("pod", "data")`` is split over both in the mesh's
    order; an axis of one rank splits nothing; with a shape, a dim that
    does not divide stays whole; an axis against the mesh's order, one
    named twice or one the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.sharding.place import local_shape_offset, to_placements
    with fake_world(8):
        m = trules.build_mesh((2, 2, 2), ("pod", "data", "model"))
        pl = to_placements((("pod", "data"), None, "model"), m)
        assert pl == (Shard(0), Shard(0), Shard(2))
        assert local_shape_offset((8, 3, 6), m, pl) == ((2, 3, 3),
                                                       (0, 0, 0))
        assert to_placements((("pod", "data"), None), m,
                             shape=(6, 4)) == (Replicate(),) * 3
        assert to_placements(("model", "data"), m, shape=(4, 3)) == (
            Replicate(), Replicate(), Shard(0))
        for bad in ((("data", "pod"),), ("data", "data"), ("expert",)):
            with pytest.raises(ValueError):
                to_placements(bad, m)
    with fake_world(4):
        m = trules.build_mesh((1, 4), ("data", "model"))
        assert to_placements(("data", "model"), m) == (Replicate(),
                                                       Shard(1))


def test_kernel_wrappers_on_placed_rows():
    """On DTensors the wrappers run the plain versions (CPU) on the local
    shard where each row is whole: `quantize_rows` / `dequantize_rows` on
    rows split over ranks (``Shard(0)``) or whole tensors, equal to the
    plain call on those rows, placements kept; a row split across ranks
    raises, and so do the row-indexing and row-summing kernels on rows
    split over ranks."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.sharding import place
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, generator=g)
    with fake_world(4):
        m = trules.build_mesh((2, 2), ("data", "model"))
        for spec in (("data",), ()):
            xd = place.distribute(x, spec, m)
            q, s = ops.quantize_rows(xd)
            assert q.placements == s.placements == xd.placements
            q0, s0 = ref.quantize_rows_ref(xd.to_local())
            assert torch.equal(q.to_local(), q0)
            assert torch.equal(s.to_local(), s0)
            d = ops.dequantize_rows(q, s)
            assert d.placements == xd.placements
            assert torch.equal(d.to_local(), ref.dequantize_rows_ref(q0, s0))
        split = place.distribute(x, (None, "model"), m)
        with pytest.raises(ValueError, match="split a row"):
            ops.quantize_rows(split)
        q, s = ops.quantize_rows(place.distribute(x, ("data",), m))
        with pytest.raises(ValueError):
            ops.dequantize_rows(q, place.distribute(torch.ones(8), (), m))
        j = torch.zeros(1, dtype=torch.long)
        with pytest.raises(ValueError, match="across rows"):
            ops.row_delta(q, s, j, torch.zeros(6))
        with pytest.raises(ValueError, match="across rows"):
            ops.masked_agg(q, s, torch.ones(8, dtype=torch.bool))
        qr = place.distribute(q.full_tensor(), (), m)
        sr = place.distribute(torch.ones(8), (), m)
        assert ops.masked_agg(qr, sr, torch.ones(8, dtype=torch.bool)
                              ).placements == (Replicate(), Replicate())


def test_mesh_constructors_without_a_group():
    """No process group: `staleness_mesh` is None (JAX's is on one device),
    the host mesh needs a group, the production mesh a world of 256 or
    512 ranks."""
    assert not torch.distributed.is_initialized()
    assert staleness_mesh() is None
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh()
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)


@contextlib.contextmanager
def _fake_rank(world, rank):
    """A fake process group of `world` ranks in which this process is
    `rank` (its mesh coordinate follows), DTensor's caches emptied after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import _forget_meshes
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _placed_param(name, shape, m):
    from repro_torch.sharding import place
    spec = tauto.param_spec((name,), torch.zeros(shape), trules.axis_sizes(m))
    return place.distribute(torch.zeros(shape), spec, m), spec


@pytest.mark.parametrize("shape,rank,experts", [
    ((2, 2), 3, 8), ((1, 4), 2, 8), ((1, 4), 1, 6), ((4, 1), 1, 8)])
def test_moe_expert_resplit_local_shapes(shape, rank, experts):
    """`moe.expert_split` lays the experts over ``model`` where
    ``("batch", "experts", None, None)``'s guarded spec does (8 experts
    over 2 or 4 ranks; 6 over 4 stay whole), and `moe.expert_weight` turns
    each expert weight, placed by its spec (d over ``data``, f over
    ``model``), into the rank's experts whole in d and f."""
    from repro_torch.models import moe
    from repro_torch.sharding.place import local_shape_offset
    d, f, C = 8, 12, 4
    with _fake_rank(4, rank):
        m = trules.build_mesh(shape, ("data", "model"))
        coord = m.get_coordinate()
        spec = trules.guarded_spec((2, experts, C, d),
                                   ("batch", "experts", None, None), m)
        ex, count, lo = moe.expert_split(m, (2, experts, C, d))
        if spec[1] == "model" and m.size(1) > 1:
            assert ex == (1,)
            assert (count, lo) == (experts // m.size(1),
                                   coord[1] * (experts // m.size(1)))
        else:
            assert (ex, count, lo) == ((), experts, 0)
        for name, dims in (("wi_gate", (d, f)), ("wo", (f, d))):
            w, wspec = _placed_param(name, (experts,) + dims, m)
            assert wspec[0] is None
            want, _ = local_shape_offset(w.shape, m, w.placements)
            assert tuple(w.to_local().shape) == want
            assert tuple(moe.expert_weight(w, ex).shape) == (count,) + dims


@pytest.mark.parametrize("shape,rank,expand", [
    ((2, 2), 3, 2), ((1, 4), 2, 2), ((1, 4), 1, 3), ((2, 2), 1, 3)])
def test_ssd_projection_relayout_local_columns(shape, rank, expand):
    """The SSD's heads on a placed (B, L, d) input lie over ``model`` where
    ``("batch", "seq", "ssm_heads", None)``'s guarded spec puts them (4
    heads over 2 or 4 ranks; 6 heads over 2, and whole over 4); a rank's
    in-projection columns are its heads' z, x and dt and all of B and C,
    its conv channels its heads' x and all of B and C — not the in-
    projection's own column split over ``model`` — and its parameters cut
    to them have those shapes."""
    import dataclasses
    from torch.distributed.tensor import Partial
    from repro_torch.models import ssm
    from repro_torch.sharding import place
    cfg = dataclasses.replace(tget_config("mamba2-780m").reduced(
        d_model=64, vocab=96), ssm_expand=expand, dtype="float32")
    H, P, N, K, di = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_conv, cfg.d_inner)
    assert cfg.ssm_groups == 1 and H == 2 * expand
    with _fake_rank(4, rank):
        m = trules.build_mesh(shape, ("data", "model"))
        coord = m.get_coordinate()
        x = place.distribute(torch.zeros(4, 16, 64), ("data",), m)
        heads = ssm._Heads(x, cfg)
        spec = trules.guarded_spec((4, 16, H, P),
                                   ("batch", "seq", "ssm_heads", None), m)
        if spec[2] == "model" and m.size(1) > 1:
            h = H // m.size(1)
            assert (heads.dims, heads.h, heads.h0) == ((1,), h, coord[1] * h)
        else:
            h = H
            assert (heads.dims, heads.h, heads.h0) == ((), H, 0)
        h0 = heads.h0
        proj, conv = heads.columns(cfg, "cpu")
        xs = list(range(h0 * P, (h0 + h) * P))
        bc = list(range(di, di + 2 * N))
        assert conv.tolist() == xs + bc
        assert proj.tolist() == xs + [di + c for c in xs + bc] + list(
            range(2 * di + 2 * N + h0, 2 * di + 2 * N + h0 + h))
        params = ssm.mamba_init(torch.Generator().manual_seed(0), cfg,
                                torch.float32)
        placed = place.distribute_tree(
            params, tauto.infer_params_shardings(params, m), m)
        ip = placed["in_proj"]
        own, off = place.local_shape_offset(ip.shape, m, ip.placements)
        assert tuple(ip.to_local().shape) == own
        p = heads.cut(heads.gather(placed, [Partial()] * 2), cfg, "cpu")
        want = {"in_proj": (64, len(proj) if heads.dims else ip.shape[1]),
                "conv_w": (K, len(conv) if heads.dims else di + 2 * N),
                "conv_b": (len(conv) if heads.dims else di + 2 * N,),
                "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm": (h * P,)}
        assert {k: tuple(v.shape) for k, v in p.items()} == want
        if heads.dims:
            # the spec's own column block mixes the sections' columns
            block = set(range(off[1], off[1] + own[1]))
            assert block != set(proj.tolist())
