"""Automatic sharding inference: leaf-path-name rules -> spec — the port of
`repro.sharding.auto`, as pure functions over shapes and the mesh's axis
sizes (a `DeviceMesh` with named dims, or a mapping ``{axis name:
size}``). A spec is a tuple with one entry per dim: a mesh-axis name, a
tuple of names, or None.

Canonical 2-D layout (single pod): TP over `model`, FSDP over `data`;
multi-pod adds `pod` to the batch axes. All rules are divisibility-guarded:
a dim that doesn't divide its axis product is replicated instead (so reduced
smoke configs and B=1 decode shapes get a layout that fits).

Rules (in/out projection convention):
  embedding (V, d)                  -> (model, data)
  in-proj   (d_in, d_out)           -> (data, model)   wq/wk/wv/wi_*/w_d*/w_u*/in_proj/router
  out-proj  (d_in, d_out)           -> (model, data)   wo/out_proj
  conv      (K, C)                  -> (None, model)
  1-D / scalars                     -> replicated
  extra leading dims (layer-stacks, expert dims, cache client rows) -> None
  KV caches (B, S, H, D)            -> (batch | None, data-if-B-unsharded, model-on-H, None)

A path is the tuple of keys from the root to a leaf: a dict key (str) or a
list or tuple index (int), as `infer_*` build them. Their consumer, the dry
run over meta-device stand-ins, is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.sharding.rules import axis_sizes

IN_PROJ = {"wq", "wk", "wv", "wi_gate", "wi_up", "w_dq", "w_uq", "w_dkv",
           "w_kr", "w_uk", "w_uv", "in_proj", "router", "w1", "w2", "w"}
OUT_PROJ = {"wo", "out_proj"}


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's (meta tensors included), () for a
    number."""
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


class _Shaped:
    """A shape standing in for a leaf (`infer_afl_shardings`' row shape)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _axis_size(mesh, name) -> int:
    sizes = axis_sizes(mesh)
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes.get(n, 1)
        return out
    return sizes.get(name, 1)


def _guard(mesh, shape, spec):
    sizes = axis_sizes(mesh)
    fixed = []
    used = set()
    for dim, s in zip(shape, spec):
        if s is None:
            fixed.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        names = tuple(n for n in names if n in sizes and n not in used)
        size = 1
        for n in names:
            size *= sizes[n]
        if names and dim % size == 0:
            fixed.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            fixed.append(None)
    return tuple(fixed)


def _leaf_name(path) -> str:
    """The last dict key of `path` (an index names nothing)."""
    for part in reversed(path):
        if isinstance(part, str):
            return part
    return ""


def _batch_axes(mesh):
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def param_spec(path, leaf, mesh, *, fsdp: bool = True):
    name = _leaf_name(path)
    shape = _shape(leaf)
    nd = len(shape)
    if name == "embedding":
        base = ("model", "data")
    elif name in IN_PROJ:
        base = ("data", "model")
    elif name in OUT_PROJ:
        base = ("model", "data")
    elif name == "conv_w":
        base = (None, "model")
    else:
        base = ()
    if not fsdp:  # pure tensor-parallel: drop the data-axis FSDP shard
        base = tuple(None if b == "data" else b for b in base)
    if len(base) > nd:
        base = base[-nd:] if nd else ()
    spec = (None,) * (nd - len(base)) + base
    return _guard(mesh, shape, spec)


def cache_spec(path, leaf, mesh, batch_sharded: bool):
    """KV/SSM/latent cache leaves. Leading dims may include a layer-stack
    dim."""
    shape = _shape(leaf)
    nd = len(shape)
    b_axes = _batch_axes(mesh)
    name = _leaf_name(path)
    if name in ("k", "v"):             # (..., B, S, H, D)
        core = [b_axes, None, "model", None]
    elif name == "latent":             # (..., B, S, R)
        core = [b_axes, None, "model"]
    elif name == "k_rope":             # (..., B, S, rd)
        core = [b_axes, None, None]
    elif name == "state":              # (..., B, H, P, N)
        core = [b_axes, "model", None, None]
    elif name == "conv":               # (..., B, K-1, C)
        core = [b_axes, None, "model"]
    else:
        core = [None] * nd
    if not batch_sharded:
        # B=1 decode: push the shard onto the sequence dim instead
        if name in ("k", "v", "latent", "k_rope"):
            core[0], core[1] = None, "data"
        else:
            core[0] = None
    spec = [None] * (nd - len(core)) + core
    return _guard(mesh, shape, spec[:nd])


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a structure of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def infer_params_shardings(params, mesh, *, fsdp: bool = True):
    return _map_with_path(lambda p, x: param_spec(p, x, mesh, fsdp=fsdp),
                          params)


def infer_afl_shardings(afl_state, mesh):
    """Cache trees {"q": (n, *param), "scale": (n,)} + running means like
    params."""
    def spec(path, x):
        name = _leaf_name(path)
        shape = _shape(x)
        if name == "scale" or len(shape) <= 1:
            return ()
        if "cache" in path or "h" in path:
            # (n_clients, *param_dims): param rule on trailing dims
            inner = param_spec(path, _Shaped(shape[1:]), mesh)
            return _guard(mesh, shape, (None,) + tuple(inner))
        return param_spec(path, x, mesh)
    return _map_with_path(spec, afl_state)


def infer_batch_shardings(batch, mesh):
    b_axes = _batch_axes(mesh)

    def spec(path, x):
        shape = _shape(x)
        if not shape:
            return ()
        return _guard(mesh, shape, (b_axes,) + (None,) * (len(shape) - 1))
    return _map_with_path(spec, batch)


def infer_decode_cache_shardings(cache, mesh, batch: int):
    b_axes = _batch_axes(mesh)
    batch_sharded = batch % max(_axis_size(mesh, b_axes), 1) == 0 and \
        _axis_size(mesh, b_axes) > 1
    return _map_with_path(
        lambda p, x: cache_spec(p, x, mesh, batch_sharded), cache)


def infer_opt_shardings(opt_state, mesh):
    def spec(path, x):
        if len(_shape(x)) <= 1:
            return ()
        return param_spec(path, x, mesh)
    return _map_with_path(spec, opt_state)
