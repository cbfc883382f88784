"""Attention: flash-style chunked GQA (memory O(L·block), not O(L²)),
sliding-window, cross-attention, single-token decode, and MLA (multi-head
latent attention, MiniCPM3/DeepSeek-style) with absorbed decode — a port
of `repro.models.attention`.

All softmax accumulation in f32. The JAX package's is pure JAX (no Pallas
kernel), and this one is PyTorch ops: the online softmax runs over kv
blocks inside a loop over q blocks, so that only one (q block, kv block)
score tile is formed at a time; GQA is a grouped product over
``(kv head, repeat)`` with no repeated heads.

On placed tensors (`repro_torch.sharding.place`) the projections gather
their weights over ``data`` and keep the heads split over ``model``
(`use_param`), q is constrained to ``("batch", "seq", "heads", None)`` as
in JAX, and a decode write lands on the rank that holds its cache slot
(`place.index_copy_placed`), so a cache split on its sequence is never
gathered. The out-projections are row-parallel (`row_parallel`): their
partial sums over ``model`` are reduced where they are made, so the
residual stream keeps its layout."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap
from repro_torch.sharding.place import index_copy_placed
from repro_torch.sharding.rules import (gather_unless_divides, is_placed,
                                        row_parallel, shard, split_heads,
                                        use_param)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Core chunked attention
# ---------------------------------------------------------------------------

def _on_local_shards(fn, q, k, v, **kw):
    """`fn`, an attention over plain (B, L, H, ·) tensors, run on each
    rank's shards of placed q, k and v, the result placed back. The batch
    keeps q's split, the heads keep theirs where it divides the kv heads (a
    query head and its kv head then live on one rank), and every other dim
    is made whole: each rank's attention is then exactly its part of the
    whole one, with no DTensor op inside the block loops."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding.place import wrap_local
    mesh = q.device_mesh
    heads = 1
    for i, p in enumerate(q.placements):
        if p.is_shard(2):
            heads *= mesh.size(i)
    keep_heads = k.shape[2] % heads == 0
    pl = tuple(p if p.is_shard(0) or (p.is_shard(2) and keep_heads)
               else Replicate() for p in q.placements)
    q, k, v = (x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
               for x in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return wrap_local(out, mesh, pl, tuple(q.shape[:3]) + (v.shape[-1],))


def chunked_attention(q, k, v, *, causal=True, window=0, softcap_val=0.0,
                      q_offset=0, q_block=512, kv_block=512):
    """q (B,Lq,H,D), k (B,Lk,Hkv,D), v (B,Lk,Hkv,Dv) -> (B,Lq,H,Dv).

    Online-softmax over kv blocks; loops over q blocks. GQA via grouped
    einsum (no materialized head repeat). ``window`` > 0 limits attention
    to the last `window` positions (inclusive of self). Placed q, k and v
    run on their local shards (`_on_local_shards`)."""
    if is_placed(q):
        return _on_local_shards(
            chunked_attention, q, k, v, causal=causal, window=window,
            softcap_val=softcap_val, q_offset=q_offset, q_block=q_block,
            kv_block=kv_block)
    B, Lq, H, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    rep = H // Hkv
    scale = D ** -0.5
    dev = q.device

    qb = min(q_block, Lq)
    kb = min(kv_block, Lk)
    pad_q = (-Lq) % qb
    pad_k = (-Lk) % kb
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Lq + pad_q) // qb, (Lk + pad_k) // kb

    # (B, n, blk, Hkv, rep/—, D)
    qs = q.reshape(B, nq, qb, Hkv, rep, D)
    ks = k.reshape(B, nk, kb, Hkv, D)
    vs = v.reshape(B, nk, kb, Hkv, Dv)

    kv_pos = torch.arange(nk * kb, device=dev).reshape(nk, kb)
    kv_valid = kv_pos < Lk

    outs = []
    for qi in range(nq):
        qblk = qs[:, qi]
        qpos = q_offset + qi * qb + torch.arange(qb, device=dev)
        m = torch.full((B, Hkv, rep, qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, rep, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, rep, qb, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk, vblk, kpos = ks[:, ki], vs[:, ki], kv_pos[ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk).float() * scale
            if softcap_val:
                s = softcap(s, softcap_val)
            mask = kv_valid[ki][None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vblk.dtype),
                              vblk).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))     # (B, qb, Hkv, rep, Dv)
    out = torch.cat(outs, dim=1).reshape(B, nq * qb, H, Dv)
    return out[:, :Lq].to(v.dtype)


def _decode_on_local_shards(q, k_cache, v_cache, valid_mask, **kw):
    """`decode_attention` on each rank's shards of a placed q and a cache
    whose sequence is whole on every rank: q takes the cache's batch and
    head splits (a query head and its kv head on one rank), the mask the
    batch's, and the output q's placements."""
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.place import local_shape_offset, wrap_local
    mesh = k_cache.device_mesh
    pl = tuple(Shard(1) if p.is_shard(2) else p for p in k_cache.placements)
    if tuple(q.placements) != pl:
        q = q.redistribute(mesh, pl)
    if tuple(v_cache.placements) != tuple(k_cache.placements):
        v_cache = v_cache.redistribute(mesh, k_cache.placements)
    if is_placed(valid_mask):       # made from a placed position
        valid_mask = valid_mask.full_tensor()
    (b, _, _), (b0, _, _) = local_shape_offset(tuple(q.shape), mesh, pl)
    out = decode_attention(q.to_local(), k_cache.to_local(),
                           v_cache.to_local(), valid_mask[b0:b0 + b], **kw)
    return wrap_local(out, mesh, pl,
                      tuple(q.shape[:2]) + (v_cache.shape[-1],))


def decode_attention(q, k_cache, v_cache, valid_mask, *, softcap_val=0.0):
    """Single-position attention. q (B,H,D); caches (B,S,Hkv,D/Dv);
    valid_mask (B,S) bool (plain). Placed, it runs on the local shards where
    the cache's sequence is whole; a cache split on its sequence (B = 1
    over ``data``) goes through DTensor's ops, whose softmax gathers the
    (B, H, S) scores over the sequence, never the cache."""
    if (is_placed(q) and is_placed(k_cache)
            and not any(p.is_shard(1) for p in k_cache.placements)):
        return _decode_on_local_shards(q, k_cache, v_cache, valid_mask,
                                       softcap_val=softcap_val)
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    rep = H // Hkv
    qg = gather_unless_divides(q, 1, Hkv).reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache).float() * (D ** -0.5)
    if softcap_val:
        s = softcap(s, softcap_val)
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache).float()
    return out.reshape(B, H, v_cache.shape[-1]).to(v_cache.dtype)


def _slot(pos, device):
    """The decode position as a 1-element int64 tensor (a Python int or a
    0-d tensor)."""
    return torch.as_tensor(pos, device=device).reshape(1).long()


# ---------------------------------------------------------------------------
# Standard GQA attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def attn_init(generator, cfg, dtype, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, cfg.num_heads * hd, dtype,
                         device=device),
        "wk": dense_init(generator, d, cfg.num_kv_heads * hd, dtype,
                         device=device),
        "wv": dense_init(generator, d, cfg.num_kv_heads * hd, dtype,
                         device=device),
        "wo": dense_init(generator, cfg.num_heads * hd, d, dtype,
                         device=device),
    }
    if cfg.qk_norm:
        dev = device or generator.device
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, x, kv_x, cos, sin, cfg, *, rope_kv=True):
    B, L, _ = x.shape
    hd = cfg.head_dim
    q = split_heads(x @ use_param(params["wq"]), cfg.num_heads, hd)
    src = x if kv_x is None else kv_x
    k = split_heads(src @ use_param(params["wk"]), cfg.num_kv_heads, hd)
    v = split_heads(src @ use_param(params["wv"]), cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        if rope_kv:
            k = apply_rope(k, cos, sin)
    return q, k, v


def attn_apply(params, x, cos, sin, cfg, *, causal=True, window=0, kv_x=None,
               return_kv=False):
    """Training / prefill self- or cross-attention."""
    q, k, v = _project_qkv(params, x, kv_x, cos, sin, cfg,
                           rope_kv=kv_x is None)
    q = shard(q, ("batch", "seq", "heads", None))
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            softcap_val=cfg.attn_softcap)
    B, L = x.shape[:2]
    y = row_parallel(out.reshape(B, L, -1), params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(params, x, cos, sin, cache, pos, cfg, *, window=0):
    """x (B,1,d); cache {"k","v"} (B,S,Hkv,hd) where S = min(window, max_len)
    if window else max_len; pos scalar (tokens already in cache). Returns
    (y, a new cache); the cache given is not written."""
    q, k, v = _project_qkv(params, x, None, cos, sin, cfg)
    k_cache, v_cache = cache["k"], cache["v"]
    S = k_cache.shape[1]
    p = _slot(pos, x.device)
    slot = torch.remainder(p, S) if window else torch.clamp(p, max=S - 1)
    k_cache = index_copy_placed(k_cache, 1, slot, k.to(k_cache.dtype))
    v_cache = index_copy_placed(v_cache, 1, slot, v.to(v_cache.dtype))
    n_valid = torch.clamp(p + 1, max=S)
    idx = torch.arange(S, device=x.device)
    valid = (idx < n_valid)[None].expand(x.shape[0], S)
    out = decode_attention(q[:, 0], k_cache, v_cache, valid,
                           softcap_val=cfg.attn_softcap)
    y = row_parallel(out.reshape(x.shape[0], 1, -1), params["wo"])
    return y, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3)
# ---------------------------------------------------------------------------

def mla_init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    H, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    dev = device or generator.device

    def dense(a, b):
        return dense_init(generator, a, b, dtype, device=device)
    return {
        "w_dq": dense(d, cfg.q_lora_rank),
        "q_norm": torch.zeros((cfg.q_lora_rank,), dtype=dtype, device=dev),
        "w_uq": dense(cfg.q_lora_rank, H * (nd + rd)),
        "w_dkv": dense(d, cfg.kv_lora_rank),
        "kv_norm": torch.zeros((cfg.kv_lora_rank,), dtype=dtype, device=dev),
        "w_kr": dense(d, rd),
        "w_uk": dense(cfg.kv_lora_rank, H * nd),
        "w_uv": dense(cfg.kv_lora_rank, H * vd),
        "wo": dense(H * vd, d),
    }


def _mla_q(params, x, cos, sin, cfg):
    B, L, _ = x.shape
    H, nd, rd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    ql = rms_norm(x @ use_param(params["w_dq"]), params["q_norm"],
                  cfg.norm_eps)
    q = split_heads(ql @ use_param(params["w_uq"]), H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_latent(params, x, cos, sin, cfg):
    latent = rms_norm(x @ use_param(params["w_dkv"]), params["kv_norm"],
                      cfg.norm_eps)
    k_rope = (x @ use_param(params["w_kr"]))[:, :, None, :]  # (B,L,1,rd)
    k_rope = apply_rope(k_rope, cos, sin)
    return latent, k_rope


def mla_apply(params, x, cos, sin, cfg, *, causal=True, window=0):
    """Training/prefill: decompress latents to full K/V, run chunked attention."""
    B, L, _ = x.shape
    H, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _mla_q(params, x, cos, sin, cfg)
    latent, k_rope = _mla_latent(params, x, cos, sin, cfg)
    k_nope = split_heads(latent @ use_param(params["w_uk"]), H, nd)
    v = split_heads(latent @ use_param(params["w_uv"]), H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, L, H, rd)], dim=-1)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            softcap_val=cfg.attn_softcap)
    return row_parallel(out.reshape(B, L, -1), params["wo"])


def _mla_absorbed_on_local_shards(q_nope, q_rope, lat_c, kr_c, w_uk, w_uv,
                                  p, scale):
    """The absorbed MLA decode core on each rank's shards, for a placed
    latent cache: q_nope (B,H,nd), q_rope (B,H,rd), lat_c (B,S,R) with R
    over ``model`` and its batch or sequence over ``data``, kr_c (B,S,rd),
    w_uk (R,H,nd) and w_uv (R,H,vd) -> v (B,H,vd), partial over ``model``.
    The heads stay whole (at 16 ranks MiniCPM3's 40 heads do not divide,
    and DTensor's own einsums would split them unevenly). Each rank forms
    its part of the scores (partial over its latent rows, summed over
    ``model``), the softmax runs over the whole sequence (the scores, not
    the cache, are gathered over ``data``), and each rank's context and
    values come from its own latent rows and sequence slice."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.place import local_shape_offset, wrap_local
    mesh = lat_c.device_mesh
    lat_pl = tuple(lat_c.placements)
    batch = tuple(Shard(0) if q.is_shard(0) else Replicate()
                  for q in lat_pl)             # q's and the scores' batch
    seq = tuple(q.is_shard(1) for q in lat_pl)    # mesh dims on S
    rows = tuple(q.is_shard(2) for q in lat_pl)   # mesh dims on R

    def local(x, pl):
        return (x if tuple(x.placements) == pl
                else x.redistribute(mesh, pl)).to_local()

    qn, qr = local(q_nope, batch), local(q_rope, batch)
    w_rows = tuple(Shard(0) if r else Replicate() for r in rows)
    wk, wv = local(w_uk, w_rows), local(w_uv, w_rows)
    lat = lat_c.to_local()
    kr = local(kr_c, tuple(Shard(1) if s_ else b
                           for s_, b in zip(seq, batch)))
    B, H, S = q_nope.shape[0], q_nope.shape[1], lat_c.shape[1]
    q_lat = torch.einsum("bhn,rhn->bhr", qn, wk)
    s1 = torch.einsum("bhr,bsr->bhs", q_lat, lat).float()
    s2 = torch.einsum("bhr,bsr->bhs", qr, kr).float()
    seq_pl = tuple(Shard(2) if s_ else b for s_, b in zip(seq, batch))
    s1 = wrap_local(s1, mesh, tuple(Partial() if r else q
                                    for r, q in zip(rows, seq_pl)),
                    (B, H, S))
    s2 = wrap_local(s2, mesh, seq_pl, (B, H, S))
    s = (local(s1, batch) + local(s2, batch)) * scale
    valid = (torch.arange(S, device=s.device) <= p)[None, None, :]
    if is_placed(valid):            # made from a placed position
        valid = valid.full_tensor()
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    (_, s_len, _), (_, s0, _) = local_shape_offset(tuple(lat_c.shape), mesh,
                                                   lat_pl)
    ctx = torch.einsum("bhs,bsr->bhr", pr[..., s0:s0 + s_len].to(lat.dtype),
                       lat)
    R = lat_c.shape[2]
    ctx = wrap_local(ctx, mesh, tuple(
        Shard(2) if r else (Partial() if s_ else b)
        for r, s_, b in zip(rows, seq, batch)), (B, H, R))
    ctx = local(ctx, tuple(Shard(2) if r else b
                           for r, b in zip(rows, batch)))
    v = torch.einsum("bhr,rhv->bhv", ctx, wv)
    return wrap_local(v, mesh, tuple(Partial() if r else b
                                     for r, b in zip(rows, batch)),
                      (B, H, w_uv.shape[2]))


def mla_decode(params, x, cos, sin, cache, pos, cfg):
    """Absorbed decode: scores and values live in latent space; the KV cache is
    (B,S,kv_rank) + (B,S,rd) — the MLA memory win."""
    B = x.shape[0]
    H, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    R = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(params, x, cos, sin, cfg)        # (B,1,H,*)
    latent, k_rope = _mla_latent(params, x, cos, sin, cfg)   # (B,1,R), (B,1,1,rd)
    S = cache["latent"].shape[1]
    p = _slot(pos, x.device)
    # an update slice's start is clamped so that the row fits, as in JAX
    slot = torch.clamp(p, max=S - 1)
    lat_c = index_copy_placed(cache["latent"], 1, slot,
                              latent.to(cache["latent"].dtype))
    kr_c = index_copy_placed(cache["k_rope"], 1, slot,
                             k_rope[:, :, 0].to(cache["k_rope"].dtype))
    w_uk = split_heads(use_param(params["w_uk"]), H, nd)
    w_uv = split_heads(use_param(params["w_uv"]), H, vd)
    if is_placed(lat_c):
        v = _mla_absorbed_on_local_shards(q_nope[:, 0], q_rope[:, 0], lat_c,
                                          kr_c, w_uk, w_uv, p,
                                          (nd + rd) ** -0.5)
        y = row_parallel(v.reshape(B, 1, H * vd), params["wo"])
        return y, {"latent": lat_c, "k_rope": kr_c}
    # absorb: q into latent space
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)   # (B,H,R)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, lat_c).float()
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0], kr_c).float()
         ) * ((nd + rd) ** -0.5)
    valid = (torch.arange(S, device=x.device) <= p)[None, None, :]
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(lat_c.dtype), lat_c)  # (B,H,R)
    v = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    y = row_parallel(v.reshape(B, 1, H * vd), params["wo"])
    return y, {"latent": lat_c, "k_rope": kr_c}
