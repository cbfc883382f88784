"""Primitive layers: norms, rotary embeddings (standard + M-RoPE), MLP,
softcap — a port of `repro.models.layers`.

Pure-functional: each layer is (init_fn, apply_fn) operating on param
dicts of tensors laid out as the JAX package's (``x @ w`` with `w` of
shape (in, out)), so that `repro_torch.convert.params_from_jax` carries a
JAX model's parameters across as they are. The init functions draw from
an explicit `torch.Generator` on its own device. A placed parameter (a
DTensor, `repro_torch.sharding.place`) is gathered over ``data`` at its
use and keeps its ``model`` split (`use_param`)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import (is_placed, row_parallel, settle,
                                        use_param)


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
    h = (F.silu(x @ use_param(params["wi_gate"]))
         * (x @ use_param(params["wi_up"])))
    return row_parallel(h, params["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(generator, vocab, d_model, dtype, device=None):
    return {"embedding": truncated_normal_init(generator, (vocab, d_model),
                                               1.0, dtype, device)}


def embed_apply(params, tokens):
    """The rows of the table at `tokens` (`F.embedding`, whose backward
    sums each row's gradient in a sorted segment reduction). A placed
    table is gathered over ``data`` and looked up vocab-parallel over
    ``model`` (`_vocab_parallel_embedding`)."""
    table = use_param(params["embedding"])
    if is_placed(table):
        return _vocab_parallel_embedding(table, tokens)
    return F.embedding(tokens.long(), table)


def _vocab_parallel_embedding(table, tokens):
    """The rows of a placed table at `tokens`, by hand on the local shards:
    each rank looks up the ids its rows hold (the others give zero rows) and
    the rows are summed over the ranks that split the vocabulary — the one
    rank that holds a row adds exact zeros to it, so the rows are the
    unplaced lookup's. The table's gradient is partial where the tokens are
    split (the ``data`` ranks' batches), which the ``data`` gather's
    backward reduce-scatters. (DTensor's own `F.embedding` rule gives a
    masked partial whose backward it cannot redistribute.)"""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.sharding.place import local_shape_offset, wrap_local
    mesh = table.device_mesh
    tok_pl = (tokens.placements if is_placed(tokens)
              else [Replicate()] * mesh.ndim)
    ids = (tokens.to_local() if is_placed(tokens) else tokens).long()
    vocab_split = [p.is_shard(0) for p in table.placements]
    local = table.to_local(grad_placements=[
        p if split else (Partial() if t.is_shard() else Replicate())
        for p, t, split in zip(table.placements, tok_pl, vocab_split)])
    _, offset = local_shape_offset(tuple(table.shape), mesh,
                                   table.placements)
    i = ids - offset[0]
    inside = (i >= 0) & (i < local.shape[0])
    rows = F.embedding(torch.clamp(i, 0, local.shape[0] - 1), local)
    rows = torch.where(inside[..., None], rows, 0.0)
    return settle(wrap_local(
        rows, mesh, [Partial() if split else t
                     for t, split in zip(tok_pl, vocab_split)],
        tuple(tokens.shape) + (table.shape[1],)))


def unembed_apply(params, x, *, logit_softcap=0.0):
    """Logits against the (tied) embedding table, as the JAX package's."""
    logits = x @ use_param(params["embedding"]).T
    return softcap(logits, logit_softcap)
