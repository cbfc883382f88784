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
from repro_torch.sharding.place import refuse_placed
from repro_torch.sharding.rules import shard


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


def moe_apply(params, x, cfg):
    """x (B, L, d) -> (y (B, L, d), aux_loss scalar).

    Group-local dispatch: tokens are grouped per sequence (G = B) unless
    L == 1 (decode: one group of the B tokens). Placed tensors over more
    than one rank raise: the experts' split over ``model`` is ROADMAP
    A13b."""
    refuse_placed(x, "the MoE FFN")
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G = B if L > 1 else 1
    Tg = (B * L) // G
    xg = x.reshape(G, Tg, d)

    logits = (xg @ params["router"]).float()                 # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, the lower index first on ties (a stable
    # descending sort keeps equal values in index order)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]            # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss (global).
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    Tk = Tg * k
    C = max(1, int(math.ceil(Tk / E * cfg.capacity_factor)))
    slot, kept, asg, filled = _routing(top_e, E, C, k)

    # each token's k assignments as rows (the backward sums over k in
    # order), packed into the (G, E·C, d) slots
    xa = xg[:, :, None, :].expand(G, Tg, k, d).reshape(G, Tk, d)
    buf = _Route.apply(xa, asg, filled, slot, kept).reshape(G, E, C, d)
    buf = shard(buf, ("batch", "experts", None, None))

    h = F.silu(torch.einsum("gecd,edf->gecf", buf, params["wi_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, params["wi_up"])
    h = shard(h, ("batch", "experts", None, None))
    out_buf = torch.einsum("gecf,efd->gecd", h, params["wo"])

    # each assignment's expert output (0 if dropped), weighted, summed
    # over its token's k choices
    ya = _Route.apply(out_buf.reshape(G, E * C, d), slot, kept, asg, filled)
    w = top_p.to(ya.dtype)
    y = (ya.reshape(G, Tg, k, d) * w[..., None]).sum(dim=2)
    return y.reshape(B, L, d), aux
