"""Primitive layers: norms, rotary embeddings (standard + M-RoPE), MLP,
softcap — a port of `repro.models.layers`.

Pure-functional: each layer is (init_fn, apply_fn) operating on param
dicts of tensors laid out as the JAX package's (``x @ w`` with `w` of
shape (in, out)), so that `repro_torch.convert.params_from_jax` carries a
JAX model's parameters across as they are. The init functions draw from
an explicit `torch.Generator` on its own device."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal_init(generator: torch.Generator, shape, scale, dtype,
                          device=None):
    """N(0, 1) truncated to [−2, 2], times ``scale / √shape[0]``, drawn on
    `generator`'s device and moved to `device` (default: that device)."""
    stddev = scale / np.sqrt(max(shape[0], 1))
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * stddev).to(device=device or generator.device, dtype=dtype)


def dense_init(generator, d_in, d_out, dtype, scale=1.0, device=None):
    return truncated_normal_init(generator, (d_in, d_out), scale, dtype,
                                 device)


# When True, rms_norm keeps the activation tensor in its compute dtype and
# upcasts only the variance *reduction* to f32 (the JAX package's switch for
# bf16 activations; no effect on f32 ones).
LOWP_NORM = False


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    if LOWP_NORM and dt != torch.float32:
        xf = x.float()
        var = ((xf * xf).sum(-1) / x.shape[-1])[..., None]
        inv = torch.rsqrt(var + eps).to(dt)
        return x * inv * (1.0 + scale.float()).to(dt)
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def softcap(x, cap):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _inv_freq(head_dim, theta, device):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions, head_dim, theta):
    """positions (..., L) int -> cos/sin (..., L, head_dim//2) f32."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions3, head_dim, theta, sections):
    """M-RoPE (Qwen2-VL): positions3 (B, 3, L) -> cos/sin (B, L, head_dim//2).

    The head_dim//2 frequency dims are split into (temporal, height, width)
    sections; each section indexes its own position stream.
    """
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    inv_freq = _inv_freq(head_dim, theta, dev)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.int64, device=dev)
                        for i, s in enumerate(sections)])          # (half,)
    B, L = positions3.shape[0], positions3.shape[-1]
    # pick the position stream per frequency dim: (B, L, half)
    pos = torch.gather(positions3.float().transpose(1, 2),         # (B, L, 3)
                       -1, sec_id[None, None, :].expand(B, L, half))
    ang = pos * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, L, H, D); cos/sin (B, L, D//2). Rotate-half (llama convention)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model, d_ff, dtype, device=None):
    return {
        "wi_gate": dense_init(generator, d_model, d_ff, dtype, device=device),
        "wi_up": dense_init(generator, d_model, d_ff, dtype, device=device),
        "wo": dense_init(generator, d_ff, d_model, dtype, device=device),
    }


def mlp_apply(params, x):
    h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(generator, vocab, d_model, dtype, device=None):
    return {"embedding": truncated_normal_init(generator, (vocab, d_model),
                                               1.0, dtype, device)}


def embed_apply(params, tokens):
    """The rows of the table at `tokens` (`F.embedding`, whose backward
    sums each row's gradient in a sorted segment reduction)."""
    return F.embedding(tokens.long(), params["embedding"])


def unembed_apply(params, x, *, logit_softcap=0.0):
    """Logits against the (tied) embedding table, as the JAX package's."""
    logits = x @ params["embedding"].T
    return softcap(logits, logit_softcap)
