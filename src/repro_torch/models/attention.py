"""Attention: flash-style chunked GQA (memory O(L·block), not O(L²)),
sliding-window, cross-attention, single-token decode, and MLA (multi-head
latent attention, MiniCPM3/DeepSeek-style) with absorbed decode — a port
of `repro.models.attention`.

All softmax accumulation in f32. The JAX package's is pure JAX (no Pallas
kernel), and this one is PyTorch ops: the online softmax runs over kv
blocks inside a loop over q blocks, so that only one (q block, kv block)
score tile is formed at a time; GQA is a grouped product over
``(kv head, repeat)`` with no repeated heads."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap
from repro_torch.sharding.rules import shard

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Core chunked attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal=True, window=0, softcap_val=0.0,
                      q_offset=0, q_block=512, kv_block=512):
    """q (B,Lq,H,D), k (B,Lk,Hkv,D), v (B,Lk,Hkv,Dv) -> (B,Lq,H,Dv).

    Online-softmax over kv blocks; loops over q blocks. GQA via grouped
    einsum (no materialized head repeat). ``window`` > 0 limits attention
    to the last `window` positions (inclusive of self)."""
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


def decode_attention(q, k_cache, v_cache, valid_mask, *, softcap_val=0.0):
    """Single-position attention. q (B,H,D); caches (B,S,Hkv,D/Dv);
    valid_mask (B,S) bool."""
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, D)
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
    q = (x @ params["wq"]).reshape(B, L, cfg.num_heads, hd)
    src = x if kv_x is None else kv_x
    Lk = src.shape[1]
    k = (src @ params["wk"]).reshape(B, Lk, cfg.num_kv_heads, hd)
    v = (src @ params["wv"]).reshape(B, Lk, cfg.num_kv_heads, hd)
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
    y = out.reshape(B, L, -1) @ params["wo"]
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
    k_cache = k_cache.index_copy(1, slot, k.to(k_cache.dtype))
    v_cache = v_cache.index_copy(1, slot, v.to(v_cache.dtype))
    n_valid = torch.clamp(p + 1, max=S)
    idx = torch.arange(S, device=x.device)
    valid = (idx < n_valid)[None].expand(x.shape[0], S)
    out = decode_attention(q[:, 0], k_cache, v_cache, valid,
                           softcap_val=cfg.attn_softcap)
    y = out.reshape(x.shape[0], 1, -1) @ params["wo"]
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
    ql = rms_norm(x @ params["w_dq"], params["q_norm"], cfg.norm_eps)
    q = (ql @ params["w_uq"]).reshape(B, L, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_latent(params, x, cos, sin, cfg):
    latent = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_rope = (x @ params["w_kr"])[:, :, None, :]          # (B,L,1,rd) shared
    k_rope = apply_rope(k_rope, cos, sin)
    return latent, k_rope


def mla_apply(params, x, cos, sin, cfg, *, causal=True, window=0):
    """Training/prefill: decompress latents to full K/V, run chunked attention."""
    B, L, _ = x.shape
    H, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _mla_q(params, x, cos, sin, cfg)
    latent, k_rope = _mla_latent(params, x, cos, sin, cfg)
    k_nope = (latent @ params["w_uk"]).reshape(B, L, H, nd)
    v = (latent @ params["w_uv"]).reshape(B, L, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, L, H, rd)], dim=-1)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            softcap_val=cfg.attn_softcap)
    return out.reshape(B, L, -1) @ params["wo"]


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
    lat_c = cache["latent"].index_copy(1, slot,
                                       latent.to(cache["latent"].dtype))
    kr_c = cache["k_rope"].index_copy(1, slot,
                                      k_rope[:, :, 0].to(cache["k_rope"].dtype))
    w_uk = params["w_uk"].reshape(R, H, nd)
    # absorb: q into latent space
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)   # (B,H,R)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, lat_c).float()
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0], kr_c).float()
         ) * ((nd + rd) ** -0.5)
    valid = (torch.arange(S, device=x.device) <= p)[None, None, :]
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(lat_c.dtype), lat_c)  # (B,H,R)
    w_uv = params["w_uv"].reshape(R, H, vd)
    v = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    y = v.reshape(B, 1, H * vd) @ params["wo"]
    return y, {"latent": lat_c, "k_rope": kr_c}
