"""Logical-axis sharding rules — the port of `repro.sharding.rules`.

Code names the *logical* axes of a tensor (``("cache_clients",
"cache_d")``, ``("batch", "seq", "embed")``); a thread-local rule set maps
them to the axes of a ``("data", "model")`` mesh, a
`torch.distributed.device_mesh.DeviceMesh` (or, for the pure spec
functions, a mapping ``{axis name: size}``). A spec is a tuple with one
entry per dim: a mesh-axis name, a tuple of names, or None (whole).

PyTorch runs one process per device, not one controller over a GSPMD
program, so a split tensor is a `torch.distributed.tensor.DTensor`: the
model, the train step, prefill and decode run laid out by the specs when
their arguments are placed (`repro_torch.sharding.place`). On a DTensor,
`shard` redistributes to the `guarded_spec` of its logical axes (JAX's
`with_sharding_constraint`), `replicate` to every rank whole, and
`use_param` gathers a parameter over ``data`` (and ``pod``) at its use, its
``model`` split kept: FSDP over ``data``, TP over ``model``. A plain tensor
comes back untouched, with or without a mesh. The server state the
staleness engine keeps in blocks — the flat cache, the history ring, the
snapshot buffer (`repro_torch.core.cache.BlockedFlatCache`) — takes its
split from `guarded_spec`, so ``use_rules(mesh, rules={"cache_d": None})``
moves it as it moves JAX's.
"""
from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

_state = threading.local()

# logical axis -> mesh axis (or tuple of mesh axes)
LOGICAL_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),      # batch shards over pod x data
    "seq": None,
    "embed": None,                 # activation embed dim replicated
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",            # expert-parallel folded into model axis
    "vocab": "model",
    "cache_clients": "data",       # ACE cache client rows
    "cache_d": "model",            # ACE cache feature shards
    # parameter dims
    "p_embed": "data",             # FSDP: shard params' embed dim over data
    "p_vocab": "model",
    "p_mlp": "model",
    "p_heads": "model",
    "p_experts": "model",
    "p_expert_ff": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
}

Spec = Tuple[object, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a `DeviceMesh` with named dims, or of a
    mapping that already is one."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


class use_rules:
    """Context manager activating a mesh + rule set for the rules' users."""

    def __init__(self, mesh, rules: Optional[Dict] = None):
        self.mesh = mesh
        self.rules = dict(LOGICAL_RULES)
        if rules:
            self.rules.update(rules)

    def __enter__(self):
        self._prev = getattr(_state, "ctx", None)
        _state.ctx = (self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        _state.ctx = self._prev
        return False


def _active():
    return getattr(_state, "ctx", None)


def active_mesh():
    """The mesh of the innermost `use_rules`, or None outside one."""
    ctx = _active()
    return ctx[0] if ctx else None


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Dict] = None, mesh=None) -> Spec:
    """The spec of logical `axes` under `rules` (default: the active rule
    set, else `LOGICAL_RULES`), its mesh axes kept only where `mesh` (default:
    the active one) has them."""
    ctx = _active()
    if rules is None:
        rules = ctx[1] if ctx else LOGICAL_RULES
    if mesh is None and ctx:
        mesh = ctx[0]
    mesh_axes = set(axis_sizes(mesh)) if mesh is not None else None
    out = []
    for ax in axes:
        m = rules.get(ax) if ax else None
        if m is None:
            out.append(None)
            continue
        if isinstance(m, (tuple, list)):
            m = tuple(a for a in m if mesh_axes is None or a in mesh_axes)
            # one name stands alone, as in JAX's canonical PartitionSpec
            out.append((m[0] if len(m) == 1 else m) if m else None)
        else:
            out.append(m if (mesh_axes is None or m in mesh_axes) else None)
    return tuple(out)


def _guard(shape, spec: Spec, sizes: Dict[str, int]) -> Spec:
    """The divisibility guard of JAX's `shard`: a dim that does not divide
    the product of its axes' sizes stays whole."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fixed = []
    for dim, s in zip(shape, spec):
        if s is None:
            fixed.append(None)
            continue
        n = 1
        for a in (s if isinstance(s, tuple) else (s,)):
            n *= sizes[a]
        fixed.append(s if dim % n == 0 else None)
    return tuple(fixed)


def guarded_spec(shape, axes: Sequence[Optional[str]], mesh=None) -> Spec:
    """The layout of a tensor of `shape` with logical `axes` under the
    active rules and `mesh` (default: the active one): `logical_to_spec`
    through the divisibility guard, the spec JAX's `shard` constrains to.
    All None without a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return (None,) * len(shape)
    return _guard(shape, logical_to_spec(axes, mesh=mesh), axis_sizes(mesh))


def is_placed(x) -> bool:
    """Whether `x` is a DTensor (laid out over a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """`x` whole on every rank: a DTensor redistributed to all-`Replicate`
    (an all-gather or all-reduce), a plain tensor as it is."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def shard(x, axes: Sequence[Optional[str]]):
    """A DTensor redistributed to the layout of its logical `axes`
    (`guarded_spec` under the active rules, on its own mesh), as JAX's
    `shard` constrains it; an all-None spec leaves it as it is, and a plain
    tensor comes back untouched."""
    if not is_placed(x):
        return x
    from repro_torch.sharding.place import to_placements
    mesh = x.device_mesh
    spec = guarded_spec(tuple(x.shape), axes, mesh)
    if all(s is None for s in spec):
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def settle(x):
    """A DTensor's partial sums reduced (its ``Partial`` placements made
    ``Replicate``: an all-reduce), its splits kept; a plain tensor as it
    is."""
    if not is_placed(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def gather_unless_divides(x, dim: int, parts: int):
    """A DTensor whose `dim` is split over ranks that do not divide `parts`
    (the heads about to be unflattened from it, or the kv heads a query's
    heads are grouped by) gathered whole along `dim`; otherwise, and for a
    plain tensor, `x` as it is. A split that does not divide a dim's first
    factor has no DTensor layout (at 16 model ranks, yi-9b's 4 kv heads)."""
    if not is_placed(x):
        return x
    dim = dim % x.dim()
    split = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            split *= x.device_mesh.size(i)
    if parts % split == 0:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements])


def split_heads(x, heads: int, head_dim: int):
    """``x (..., heads·head_dim) -> (..., heads, head_dim)``, a placed `x`
    gathered first where its split does not divide `heads`."""
    x = gather_unless_divides(x, -1, heads)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def row_parallel(x, w):
    """``x @ w`` for an out-projection: a placed `w` gathered over ``data``
    (`use_param`) with its rows split over ``model``, `x`'s last dim
    redistributed to that split first — an explicit, differentiable step:
    the slice DTensor would make inside the product leaves a gradient its
    backward cannot view back into heads — and the partial sums over
    ``model`` reduced (`settle`), so the residual stream keeps its layout.
    Plain tensors: ``x @ w``."""
    w = use_param(w)
    if is_placed(x) and is_placed(w):
        from torch.distributed.tensor import Shard
        last = x.dim() - 1
        pl = tuple(Shard(last) if pw.is_shard(0) else px
                   for px, pw in zip(x.placements, w.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return settle(x @ w)


#: the mesh axes a parameter is gathered over at its use (FSDP)
FSDP_AXES = ("pod", "data")


def use_param(p):
    """A placed parameter as its use needs it: whole over ``data`` and
    ``pod`` (the FSDP all-gather), its ``model`` split kept (TP). Autograd
    turns the gather into the reduce-scatter of its gradient. A plain
    tensor comes back untouched."""
    if not is_placed(p):
        return p
    from torch.distributed.tensor import Replicate
    mesh = p.device_mesh
    placements = tuple(Replicate() if name in FSDP_AXES else pl
                       for name, pl in zip(mesh.mesh_dim_names,
                                           p.placements))
    if placements == tuple(p.placements):
        return p
    return p.redistribute(mesh, placements)


def build_mesh(shape, names):
    """A `DeviceMesh` of `shape` with dims `names` over the ranks of the
    initialised process group: on ``cuda`` when the group is NCCL's (its
    ranks hold cards), on ``cpu`` otherwise (``gloo``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first (or "
                           "start under torchrun)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def warm_up_groups(mesh, device) -> None:
    """One all-reduce on each of `mesh`'s dim groups, so that each group's
    communicator exists before a CUDA graph records its collectives."""
    import torch
    import torch.distributed as dist
    for name in mesh.mesh_dim_names:
        x = torch.zeros((1,), device=device)
        dist.all_reduce(x, group=mesh.get_group(name))


def param_spec_fn(path_logical_axes, mesh):
    """Build a logical-axes tree -> spec tree function (the launch
    helper): dicts are walked, and each tuple or list of logical axes (a
    leaf, as in JAX) becomes its `logical_to_spec` under `mesh`."""
    def fn(logical_axes_tree):
        def walk(x):
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            return logical_to_spec(x, mesh=mesh)
        return walk(logical_axes_tree)
    return fn
