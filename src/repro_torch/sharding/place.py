"""Placement: the specs of `repro_torch.sharding.auto` made into DTensor
layouts — the port's counterpart of the ``in_shardings`` that JAX's dry
run hands `jax.jit` (`repro.launch.dryrun.lower_train` /
`lower_prefill` / `lower_decode`).

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or None (whole). `to_placements` turns it into the placements of
a `torch.distributed.tensor.DTensor` over a named `DeviceMesh`, one per
mesh dim: ``Shard(d)`` where the spec puts that mesh axis on dim d, else
``Replicate()``. A dim split over several axes (``("pod", "data")`` for
the batch) is split over them in the mesh's order, as JAX splits it; an axis
of one rank splits nothing and is left ``Replicate()``.

`place_train`, `place_prefill` and `place_decode` place a mode's arguments
by the specs JAX's dry run gives them: the parameters TP over ``model`` and
FSDP over ``data``, the optimizer and AFL state likewise (the AFL tree
cache replicated, ROADMAP C16), the batch over ``("pod", "data")`` and the
decode cache's heads over ``model`` with its batch, or at a batch that
does not divide, its sequence, over ``data``. Each rank holds only its
shard; `full_tree` gathers whole tensors back for comparisons and host
reads. The model, the train step, prefill and decode run on placed
arguments as they are (`repro_torch.sharding.rules.shard`, `use_param`);
where DTensor's ops cannot carry a layout (the MoE's routing and expert
products, the SSD's heads, attention), a part runs on each rank's local
shards as plain tensors (`whole_local`, `wrap_local`, `all_reduce_grad`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.sharding.auto import (infer_afl_shardings,
                                       infer_batch_shardings,
                                       infer_decode_cache_shardings,
                                       infer_opt_shardings,
                                       infer_params_shardings)
from repro_torch.sharding.rules import _guard, axis_sizes, is_placed


def to_placements(spec, mesh, shape: Optional[Sequence[int]] = None
                  ) -> Tuple:
    """The DTensor placements of `spec` on the named `mesh`, one per mesh
    dim. With `shape`, a dim that does not divide the product of its axes'
    sizes stays whole (the rules' divisibility guard). An axis the mesh
    lacks, an axis named twice, or a dim whose axes run against the mesh's
    order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    spec = tuple(spec or ())
    if shape is not None:
        spec = _guard(tuple(shape), spec, axis_sizes(mesh))
    out = [Replicate()] * len(names)
    taken = set()
    for dim, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: the mesh {names} has no axis "
                                 f"{a!r}")
            if a in taken:
                raise ValueError(f"spec {spec}: axis {a!r} named twice")
            taken.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} is split over {axes}, "
                             f"against the mesh's order {names}")
        for i in idx:
            if mesh.size(i) > 1:     # one rank's share is the whole dim
                out[i] = Shard(dim)
    return tuple(out)


def local_shape_offset(shape, mesh, placements):
    """``(local shape, global offset)`` of this rank's shard of a tensor of
    `shape` laid out by `placements` on `mesh`, every split even (the
    specs' guard makes it so): a dim split over several mesh dims is split
    in their order, as `to_placements` lays it out. Plain arithmetic on the
    mesh coordinate, so it holds under a fake mode too."""
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            local[p.dim] //= n
            offset[p.dim] += coord[i] * local[p.dim]
    return tuple(local), tuple(offset)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def wrap_local(t, mesh, placements, shape):
    """This rank's shard `t` of a tensor of global `shape` laid out by
    `placements`, as a DTensor (no collective, no check)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def split_dims(x, dim: int) -> Tuple[int, ...]:
    """The mesh dims (of more than one rank) that split dim `dim` of a
    DTensor `x`."""
    mesh = x.device_mesh
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard(dim) and mesh.size(i) > 1)


def spec_dims(mesh, entry) -> Tuple[int, ...]:
    """The mesh dims (of more than one rank) that a spec entry (a mesh-axis
    name, a tuple of names, or None) splits over."""
    names = tuple(mesh.mesh_dim_names)
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(names.index(a) for a in axes
                 if a is not None and mesh.size(names.index(a)) > 1)


def batch_split_only(x):
    """A DTensor `x` with only its batch's (dim 0's) split kept, every other
    mesh dim made whole."""
    from torch.distributed.tensor import Replicate
    pl = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def whole_local(p, grad_placements):
    """A placed tensor gathered whole on every rank, as a plain tensor whose
    gradient comes back laid out by `grad_placements` (``Partial`` over the
    mesh dims whose ranks each add their own part of it: the batch's split,
    or a split of the work that reads it) and is then redistributed to
    `p`'s own placements — a reduce-scatter where `p` is split."""
    from torch.distributed.tensor import Replicate
    mesh = p.device_mesh
    whole = [Replicate()] * mesh.ndim
    if tuple(p.placements) != tuple(whole):
        p = p.redistribute(mesh, whole)
    return p.to_local(grad_placements=tuple(grad_placements))


def _sum_over(t, groups):
    import torch.distributed as dist
    t = t.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


class _SumBothWays(torch.autograd.Function):
    """A sum over the ranks of `groups` whose backward is the same sum."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _sum_over(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.groups), None


def all_reduce_grad(t, mesh, dims):
    """`t` summed over the ranks of the mesh dims `dims`, its gradient
    summed the same way in the backward pass (each rank's part of the
    result is used by that rank's own work): Megatron's reduce on both
    passes. No dims: `t` as it is."""
    if not dims:
        return t
    return _SumBothWays.apply(t, tuple(mesh.get_group(i) for i in dims))


def _map2(fn, tree, specs):
    """`fn(leaf, spec)` over the tensors of `tree` and the matching nodes of
    `specs` (dicts, lists, tuples and named tuples kept; a spec is a tuple,
    so the walk follows `tree`); anything else passes through."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, x, s) for x, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, x, s) for x, s in zip(tree, specs))
    return fn(tree, specs) if isinstance(tree, torch.Tensor) else tree


def _map(fn, tree):
    """`fn` over the tensors of `tree` (structure kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def distribute(x: torch.Tensor, spec, mesh):
    """`x` (whole, the same on every rank) as a DTensor laid out by `spec`:
    each rank keeps its own shard, no collective. A DTensor is
    redistributed to the spec's placements."""
    placements = to_placements(spec, mesh)
    if is_placed(x):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor_local(x, mesh, placements)


def distribute_tree(tree, spec_tree, mesh, *, whole_plain: bool = False):
    """Every tensor of `tree` placed by its spec in `spec_tree` (as
    `repro_torch.sharding.auto.infer_*_shardings` build them). With
    `whole_plain`, a leaf its spec splits over no rank stays a plain tensor
    — held whole on every rank, which is what replicated means (the server
    state's bookkeeping and its tree cache: their ops then never meet
    DTensor's op coverage)."""
    def one(x, spec):
        if whole_plain and all(p.is_replicate()
                               for p in to_placements(spec, mesh)):
            return x.full_tensor() if is_placed(x) else x
        return distribute(x, spec, mesh)
    return _map2(one, tree, spec_tree)


def full_tree(tree):
    """`tree` with each DTensor gathered whole (plain tensors untouched)."""
    return _map(lambda x: x.full_tensor() if is_placed(x) else x, tree)


def same_layout(a, b) -> bool:
    """Whether two DTensors have the same placements."""
    return tuple(a.placements) == tuple(b.placements)


def like(new, old):
    """`new` laid out as `old` is: a DTensor of other placements
    redistributed, a plain tensor where `old` is replicated placed beside
    it, a DTensor where `old` is plain gathered whole."""
    if not is_placed(old):
        return new.full_tensor() if is_placed(new) else new
    if is_placed(new):
        if same_layout(new, old):
            return new
        return new.redistribute(old.device_mesh, old.placements)
    from torch.distributed.tensor import DTensor
    if any(not p.is_replicate() for p in old.placements):
        raise ValueError("a plain tensor where a split one was")
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False)


def like_tree(new, old):
    """`like` over two trees of one structure."""
    if isinstance(new, dict):
        return {k: like_tree(v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(like_tree(a, b) for a, b in zip(new, old)))
    if isinstance(new, (list, tuple)):
        return type(new)(like_tree(a, b) for a, b in zip(new, old))
    if isinstance(new, torch.Tensor):
        return like(new, old)
    return new


def tree_mesh(tree):
    """The mesh of the first DTensor in `tree`, or None."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for x in tree:
            m = tree_mesh(x)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_placed(tree) else None


def placed_scope(*trees):
    """A context in which plain tensors meet DTensors as replicated ones
    (`implicit_replication`: the masks, positions and constants a step makes
    are the same on every rank) where any of `trees` holds a DTensor, else
    a null context. Nested scopes keep the outer one's setting."""
    if all(tree_mesh(t) is None for t in trees):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def index_copy_placed(x, dim: int, index, src):
    """``x.index_copy(dim, index, src)`` (out of place) for a one-element
    `index`. On a DTensor `x` that may be split along `dim` (a decode cache
    whose sequence lies over ``data``), `src` is laid out as `x` with `dim`
    whole and each rank writes its own shard: the rank whose rows hold the
    slot writes it, every other rank writes back the row it holds — no
    gather of the cache, no host read of the index."""
    if not is_placed(x):
        return x.index_copy(dim, index, src)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    row_pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if not is_placed(src):
        src = distribute_tensor_local(src, mesh, row_pl)
    elif tuple(src.placements) != tuple(row_pl):
        src = src.redistribute(mesh, row_pl)
    if is_placed(index):
        index = index.full_tensor()
    local = x.to_local()
    _, offset = local_shape_offset(tuple(x.shape), mesh, x.placements)
    i = index.reshape(1) - offset[dim]
    n = local.shape[dim]
    inside = ((i >= 0) & (i < n)).reshape((1,) * local.dim())
    at = torch.clamp(i, 0, n - 1)
    row = torch.where(inside, src.to_local(), local.index_select(dim, at))
    return DTensor.from_local(local.index_copy(dim, at, row), mesh,
                              x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_tensor_local(x, mesh, placements):
    """A whole tensor (the same on every rank) as a DTensor of
    `placements`, each rank keeping its shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


# ---------------------------------------------------------------------------
# The modes' arguments, placed as JAX's dry run places them
# ---------------------------------------------------------------------------

def train_specs(state, batch, mesh, *, fsdp: bool = True):
    """The specs of an `AFLTrainState` and a batch (JAX's `lower_train`):
    params (FSDP over ``data`` unless `fsdp` is False), optimizer and AFL
    state by `infer_*_shardings`, the step replicated."""
    specs = type(state)(
        params=infer_params_shardings(state.params, mesh, fsdp=fsdp),
        opt_state=infer_opt_shardings(state.opt_state, mesh),
        afl=infer_afl_shardings(state.afl, mesh), step=())
    return specs, infer_batch_shardings(batch, mesh)


def place_train(state, batch, mesh, fsdp: bool = True):
    """``(state, batch)`` placed by `train_specs`: the parameters and the
    batch as DTensors, the optimizer, AFL state and step with the leaves
    their specs split as DTensors and the others whole (`distribute_tree`'s
    ``whole_plain``; JAX's specs replicate the AFL tree cache, C16)."""
    s_spec, b_spec = train_specs(state, batch, mesh, fsdp=fsdp)
    params = distribute_tree(state.params, s_spec.params, mesh)
    rest = distribute_tree(state._replace(params=None),
                           s_spec._replace(params=None), mesh,
                           whole_plain=True)
    return (rest._replace(params=params),
            distribute_tree(batch, b_spec, mesh))


def place_batch(batch, mesh):
    """A batch (a tree of tensors leading with the batch) placed over
    ``("pod", "data")`` (`infer_batch_shardings`): the later steps'
    batches of a placed state."""
    return distribute_tree(batch, infer_batch_shardings(batch, mesh), mesh)


def place_prefill(params, batch, mesh):
    """``(params, batch)`` placed as JAX's `lower_prefill` places them."""
    return (distribute_tree(params, infer_params_shardings(params, mesh),
                            mesh),
            place_batch(batch, mesh))


def decode_specs(params, cache, tokens, mesh):
    return (infer_params_shardings(params, mesh),
            infer_decode_cache_shardings(cache, mesh, int(tokens.shape[0])),
            infer_batch_shardings(tokens, mesh))


def place_decode(params, cache, tokens, mesh):
    """``(params, cache, tokens)`` placed as JAX's `lower_decode` places
    them: the cache's heads over ``model`` and its batch over ``data``, or
    its sequence where the batch does not divide."""
    p_spec, c_spec, t_spec = decode_specs(params, cache, tokens, mesh)
    return (distribute_tree(params, p_spec, mesh),
            distribute_tree(cache, c_spec, mesh),
            distribute(tokens, t_spec, mesh))
