"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) block — a port of
`repro.models.ssm`.

Training/prefill uses the chunked SSD algorithm: the intra-chunk quadratic
("attention-like") term as batched matrix products, and the inter-chunk
recurrent state passed by a Python loop over the chunks (where JAX scans).
Decode is the O(1) single-step recurrence on a persistent (H, P, N) state
plus a depthwise-conv ring cache. The JAX package's SSD is plain JAX (no
Pallas kernel), and so is this one plain PyTorch. `A_log`, `D` and
`dt_bias` are float32 whatever the config's dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.place import refuse_placed
from repro_torch.sharding.rules import shard


def mamba_init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    di, N, H, G, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_groups, cfg.ssm_conv)
    conv_ch = di + 2 * G * N
    dev = device or generator.device
    in_proj = dense_init(generator, d, 2 * di + 2 * G * N + H, dtype,
                         device=device)
    conv_w = torch.randn((K, conv_ch), generator=generator,
                         device=generator.device) * 0.1
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(device=dev, dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -4.6, dtype=torch.float32,
                              device=dev),            # softplus ~ 0.01
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, d, dtype, device=device),
    }


def _split_zxbcdt(zxbcdt, cfg):
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over L. xBC (B,L,C); w (K,C)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _segsum(a):
    """a (..., Q) -> (..., Q, Q) with L[l, s] = sum_{i in (s, l]} a_i
    (l >= s), −inf above the diagonal (its exp is 0, and so is the
    gradient there: `torch.where` passes none to the branch it drops)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, dif, float("-inf"))


def ssd_chunked(x, a, Bm, Cm, cfg, init_state=None):
    """Chunked SSD scan.

    x  (B, L, H, P)   head inputs (already scaled by dt)
    a  (B, L, H)      log-decay per step (dt * A, negative)
    Bm, Cm (B, L, G, N)
    returns y (B, L, H, P), final_state (B, H, P, N)
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    xr = x.reshape(Bsz, nc, Q, G, Hg, P)
    ar = a.reshape(Bsz, nc, Q, H).float()
    Br = Bm.reshape(Bsz, nc, Q, G, N)
    Cr = Cm.reshape(Bsz, nc, Q, G, N)

    a_cum = torch.cumsum(ar, dim=2)                                 # (B,nc,Q,H)
    Lmat = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))               # (B,nc,H,Q,Q)
    Lmat = Lmat.reshape(Bsz, nc, G, Hg, Q, Q)

    # intra-chunk (diagonal) term
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cr.float(), Br.float())  # (B,nc,G,Q,Q)
    scores = CB[:, :, :, None] * Lmat                               # (B,nc,G,Hg,Q,Q)
    y_diag = torch.einsum("bcghls,bcsghp->bclghp", scores.to(x.dtype), xr)

    # chunk-final states
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)           # (B,nc,Q,H)
    xd = xr * decay_states.reshape(Bsz, nc, Q, G, Hg)[..., None].to(x.dtype)
    states = torch.einsum("bcsgn,bcsghp->bcghpn", Br, xd)           # (B,nc,G,Hg,P,N)

    chunk_decay = torch.exp(a_cum[:, :, -1, :]).reshape(Bsz, nc, G, Hg)

    # the inter-chunk recurrence (JAX's lax.scan over the chunks)
    if init_state is None:
        prev = torch.zeros((Bsz, G, Hg, P, N), dtype=x.dtype, device=x.device)
    else:
        prev = init_state.reshape(Bsz, G, Hg, P, N)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = (prev * chunk_decay[:, c, ..., None, None].to(prev.dtype)
                + states[:, c])
    final = prev
    prev_states = torch.stack(prevs, dim=1)                         # (B,nc,G,Hg,P,N)

    # inter-chunk (off-diagonal) term
    state_decay = torch.exp(a_cum).reshape(Bsz, nc, Q, G, Hg)
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp", Cr.float(),
                         prev_states.float(), state_decay).to(x.dtype)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y, final.reshape(Bsz, H, P, N)


def mamba_apply(params, x, cfg):
    """Full-sequence Mamba2 block. x (B, L, d) -> (B, L, d). Placed
    tensors over more than one rank raise (the heads' split is ROADMAP
    A13b)."""
    refuse_placed(x, "the Mamba-2 SSD")
    B, L, _ = x.shape
    di, N, G, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xBC, dt = _split_zxbcdt(x @ params["in_proj"], cfg)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xp = xBC[..., :di].reshape(B, L, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B, L, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, L, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"])                  # (B,L,H)
    A = -torch.exp(params["A_log"])                                  # (H,)
    xp = shard(xp, ("batch", "seq", "ssm_heads", None))
    y, _ = ssd_chunked(xp * dt[..., None].to(x.dtype), dt * A, Bm, Cm, cfg)
    y = y + xp * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, L, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def mamba_init_cache(cfg, batch, dtype, device=None):
    di, N, G, H, P, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                         cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv)
    conv_ch = di + 2 * G * N
    return {
        "conv": torch.zeros((batch, K - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def mamba_decode(params, x, cache, cfg):
    """Single-step recurrence. x (B, 1, d) -> (y (B,1,d), a new cache); the
    cache given is not written. Placed tensors over more than one rank
    raise (ROADMAP A13b)."""
    refuse_placed(x, "the Mamba-2 SSD")
    B = x.shape[0]
    di, N, G, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xBC, dt = _split_zxbcdt((x @ params["in_proj"])[:, 0], cfg)  # (B, *)
    conv_buf = torch.cat([cache["conv"], xBC[:, None]], dim=1)       # (B,K,C)
    new_conv = conv_buf[:, 1:]
    xBC = F.silu(torch.einsum("bkc,kc->bc", conv_buf, params["conv_w"])
                 + params["conv_b"])
    xp = xBC[..., :di].reshape(B, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"])                  # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                        # (B,H)
    Hg = H // G
    xdt = (xp * dt[..., None].to(xp.dtype)).reshape(B, G, Hg, P)
    upd = torch.einsum("bgn,bghp->bghpn", Bm, xdt).reshape(B, H, P, N)
    state = cache["state"] * decay[..., None, None] + upd.float()
    y = torch.einsum("bghpn,bgn->bghp", state.reshape(B, G, Hg, P, N),
                     Cm.float()).reshape(B, H, P)
    y = y.to(x.dtype) + xp * params["D"][None, :, None].to(x.dtype)
    y = y.reshape(B, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    y = (y @ params["out_proj"])[:, None]
    return y, {"conv": new_conv, "state": state}
