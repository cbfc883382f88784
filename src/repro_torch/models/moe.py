"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch — a
port of `repro.models.moe`.

Tokens are grouped per sequence (G = B, or one group when L = 1), their
(token, choice) assignments sorted by expert id (a stable sort, as
``jnp.argsort``), and each expert's first C = ceil(Tk/E · capacity_factor)
assignments packed into a dense (G, E, C, d) buffer; overflow is dropped
(the Switch capacity discipline). The expert FFN runs as batched matrix
products over the buffer.

The JAX package packs with a scatter-add (``.at[].add``) and combines with
another, and the backward of its token gather sums each token's k rows.
Here no floating-point sum depends on an order that a device picks: the
pack is a gather through the sort permutation and its backward a gather
through the inverse (`_Route`), and the combine gathers each token's k
expert outputs as (Tg, k, d) and sums over k in index order. So a graph
run equals its eager run bit for bit, and two gradients of one batch are
equal."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding.rules import (guarded_spec, is_placed, replicate,
                                        shard, use_param)


def moe_init(generator, cfg, dtype, device=None):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def experts(a, b):
        # JAX vmaps `dense_init` over the experts: each (a, b) matrix is
        # scaled by 1/sqrt(a)
        return torch.stack([dense_init(generator, a, b, dtype, device=device)
                            for _ in range(E)])
    return {
        "router": dense_init(generator, d, E, dtype, device=device),
        "wi_gate": experts(d, f),
        "wi_up": experts(d, f),
        "wo": experts(f, d),
    }


def _gather_rows(src, idx, mask):
    """out[g, i] = src[g, idx[g, i]] where mask[g, i], else 0."""
    d = src.shape[-1]
    out = torch.gather(src, 1, idx[..., None].expand(*idx.shape, d))
    return torch.where(mask[..., None], out, torch.zeros((), dtype=src.dtype,
                                                         device=src.device))


class _Route(torch.autograd.Function):
    """A gather of rows along a partial one-to-one map, whose backward is
    the gather along the inverse map (no scatter, so no atomic adds):
    ``out[g, i] = src[g, fwd[g, i]]`` where ``fwd_mask``, and the map from
    out rows to src rows is one to one on the masked rows, with
    ``bwd[g, j]`` the out row that src row j went to (``bwd_mask`` false
    where it went to none)."""

    @staticmethod
    def forward(ctx, src, fwd, fwd_mask, bwd, bwd_mask):
        ctx.save_for_backward(bwd, bwd_mask)
        return _gather_rows(src, fwd, fwd_mask)

    @staticmethod
    def backward(ctx, grad):
        bwd, bwd_mask = ctx.saved_tensors
        return _gather_rows(grad, bwd, bwd_mask), None, None, None, None


def _routing(top_e, E, C, k):
    """The dispatch plan of (G, Tg, k) expert choices -> (slot of each
    assignment a = t·k + choice (G, Tk), whether it was kept (G, Tk), the
    assignment in each slot e·C + c (G, E·C), whether the slot is filled
    (G, E·C))."""
    G, Tg, _ = top_e.shape
    Tk = Tg * k
    dev = top_e.device
    fe = top_e.reshape(G, Tk)
    sort_i = torch.argsort(fe, dim=-1, stable=True)
    sorted_e = torch.gather(fe, 1, sort_i).contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(Tk, device=dev) - first
    kept_sorted = ranks < C
    slot_sorted = sorted_e * C + torch.clamp(ranks, max=C - 1)
    inv = torch.argsort(sort_i, dim=-1)             # sort_i's inverse
    slot = torch.gather(slot_sorted, 1, inv)
    kept = torch.gather(kept_sorted, 1, inv)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    lo = torch.searchsorted(sorted_e, experts, side="left")
    hi = torch.searchsorted(sorted_e, experts, side="right")
    c = torch.arange(C, device=dev)
    filled = (c < (hi - lo)[..., None]).reshape(G, E * C)
    pos = torch.clamp(lo[..., None] + c, max=Tk - 1).reshape(G, E * C)
    return slot, kept, torch.gather(sort_i, 1, pos), filled


def _experts(buf, wi_gate, wi_up, wo):
    """The expert FFN over a (G, E, C, d) buffer and E experts' weights."""
    buf = shard(buf, ("batch", "experts", None, None))
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, wi_gate)) \
        * torch.einsum("gecd,edf->gecf", buf, wi_up)
    h = shard(h, ("batch", "experts", None, None))
    return torch.einsum("gecf,efd->gecd", h, wo)


def moe_apply(params, x, cfg):
    """x (B, L, d) -> (y (B, L, d), aux_loss scalar).

    Group-local dispatch: tokens are grouped per sequence (G = B) unless
    L == 1 (decode: one group of the B tokens). Placed, it runs on each
    rank's local shards (`_moe_placed`)."""
    if is_placed(x):
        return _moe_placed(params, x, cfg)
    return _moe(x, x, params["router"], cfg, lambda buf: _experts(
        buf, params["wi_gate"], params["wi_up"], params["wo"]))


def _moe(x_router, x_experts, router, cfg, experts, mean=None, lo=0,
         count=None):
    """The MoE on plain tensors: `x_router` feeds the router and
    `x_experts` the dispatch (one tensor, or two views of one whose
    gradients are laid out apart); `experts(buf)` maps the dispatch buffer
    of the `count` experts from `lo` (default: all) to every expert's
    outputs (G, E, C, d); `mean` takes the load-balance loss's means over
    the groups to the means over every rank's groups."""
    B, L, d = x_router.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    count = E if count is None else count
    G = B if L > 1 else 1
    Tg = (B * L) // G
    xg = x_router.reshape(G, Tg, d)

    logits = (xg @ router).float()                           # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, the lower index first on ties (a stable
    # descending sort keeps equal values in index order)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]            # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss (global).
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    if mean is not None:
        me, ce = mean(me), mean(ce)
    aux = E * torch.sum(me * ce)

    Tk = Tg * k
    C = _capacity(Tk, cfg)
    slot, kept, asg, filled = _routing(top_e, E, C, k)

    # each token's k assignments as rows (the backward sums over k in
    # order), packed into the (G, count·C, d) slots of the experts held
    xe = xg if x_experts is x_router else x_experts.reshape(G, Tg, d)
    xa = xe[:, :, None, :].expand(G, Tg, k, d).reshape(G, Tk, d)
    if count != E:
        span = slice(lo * C, (lo + count) * C)
        held = (slot >= span.start) & (slot < span.stop)
        buf = _Route.apply(xa, asg[:, span], filled[:, span],
                           torch.clamp(slot - span.start, 0, count * C - 1),
                           kept & held)
    else:
        buf = _Route.apply(xa, asg, filled, slot, kept)
    out_buf = experts(buf.reshape(G, count, C, d))

    # each assignment's expert output (0 if dropped), weighted, summed
    # over its token's k choices
    ya = _Route.apply(out_buf.reshape(G, E * C, d), slot, kept, asg, filled)
    w = top_p.to(ya.dtype)
    y = (ya.reshape(G, Tg, k, d) * w[..., None]).sum(dim=2)
    return y.reshape(B, L, d), aux


def _capacity(Tk, cfg) -> int:
    return max(1, int(math.ceil(Tk / cfg.num_experts * cfg.capacity_factor)))


def expert_split(mesh, buf_shape):
    """How the experts of a (G, E, C, d) dispatch buffer lie on `mesh`, as
    JAX's ``shard(buf, ("batch", "experts", None, None))`` lays them
    (guarded): ``(the mesh dims that split them, the count a rank holds,
    its first)``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.place import local_shape_offset, spec_dims
    spec = guarded_spec(tuple(buf_shape), ("batch", "experts", None, None),
                        mesh)
    ex = spec_dims(mesh, spec[1])
    (count,), (lo,) = local_shape_offset(
        (buf_shape[1],), mesh,
        [Shard(0) if i in ex else Replicate() for i in range(mesh.ndim)])
    return ex, count, lo


def expert_weight(p, ex, groups=()):
    """A placed expert weight ((E, ·, ·), by its spec split over ``data``
    and over ``model`` on its last two dims) as a rank's experts need it: a
    plain (count, ·, ·) tensor of its experts (`expert_split`'s), whole in
    its other dims — `use_param`'s gather over ``data``, then the split
    over ``model`` moved onto the experts (an all-to-all). Its gradient is
    partial over the mesh dims `groups` that split the batch's groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = p.device_mesh
    pl = [Shard(0) if i in ex else Replicate() for i in range(mesh.ndim)]
    p = use_param(p)
    if tuple(p.placements) != tuple(pl):
        p = p.redistribute(mesh, pl)
    return p.to_local(grad_placements=[
        Partial() if i in groups else q for i, q in enumerate(pl)])


def _moe_placed(params, x, cfg):
    """The MoE on placed tensors, on each rank's local shards, laid out as
    JAX lays it out: the groups of its batch over ``data`` (at decode, the
    one group of all B tokens gathered whole first and split again after)
    and the experts over ``model`` (``("batch", "experts", None, None)``,
    guarded). Each rank routes its own groups as plain tensors (the sort,
    the searchsorted, the gathers: no DTensor rule for them is trusted),
    packs the slots of the experts it holds, runs their products with the
    weights gathered whole from their specs (`use_param`'s gather over
    ``data``, the split of f over ``model`` re-laid onto the experts), and
    gathers every expert's outputs over ``model`` so that
    each token's k outputs are summed in index order. The load-balance
    loss's means are averaged over the ranks that split the groups.
    Gradients: the router's and the expert weights' partial over the
    group split (reduce-scattered back to their specs), the input's
    dispatch part partial over the expert split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.place import (batch_split_only, split_dims,
                                            whole_local, wrap_local)
    mesh, nd = x.device_mesh, x.device_mesh.ndim
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G = B if L > 1 else 1
    xw = batch_split_only(x) if L > 1 else replicate(x)
    groups = split_dims(xw, 0)
    C = _capacity((B * L // G) * k, cfg)
    ex, count, lo = expert_split(mesh, (G, E, C, d))
    router = whole_local(params["router"], [
        Partial() if i in groups else Replicate() for i in range(nd)])
    wg, wu, wo = (expert_weight(params[n], ex, groups)
                  for n in ("wi_gate", "wi_up", "wo"))
    xr = xw.to_local()
    xe = xr if not ex else xw.to_local(grad_placements=[
        Partial() if i in ex else p for i, p in enumerate(xw.placements)])
    n_groups = 1
    for i in groups:
        n_groups *= mesh.size(i)

    def mean(t):
        part = [Partial() if i in groups else Replicate() for i in range(nd)]
        return wrap_local(t / n_groups, mesh, part, t.shape).full_tensor()

    def experts(buf):
        out = _experts(buf, wg, wu, wo)
        if not ex:
            return out
        shard_pl = [Shard(1) if i in ex else xw.placements[i]
                    for i in range(nd)]
        whole_pl = [Replicate() if i in ex else xw.placements[i]
                    for i in range(nd)]
        return wrap_local(out, mesh, shard_pl, (G, E, C, d)).redistribute(
            mesh, whole_pl).to_local()

    y, aux = _moe(xr, xe, router, cfg, experts,
                  mean=mean if groups else None, lo=lo, count=count)
    y = wrap_local(y, mesh, xw.placements, x.shape)
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(mesh, x.placements)
    return y, wrap_local(aux, mesh, (Replicate(),) * nd, ())
