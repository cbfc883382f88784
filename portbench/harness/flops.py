"""The operations of one client gradient and the bytes of the quant
kernels, from a configuration's numbers alone: the yardstick of `mfu` and
`quant_roofline`, and the peaks they are shares of.

`forward_flops` is the repository's analytic count (``launch/analytic.py``
and the parameter count of ``configs/base.py``), frozen here for the
layer kinds the plain reference has (dense attention, windowed attention,
Mamba-2, the shared block; no latent attention, experts or encoder): matrix
products 2·M·N·K over the active parameters but the embedding lookup, the
attention scores and values over the causal half, the SSD's chunked
products. It leaves out the logits' product against a tied embedding
(the lookup and the logits share the one table it subtracts);
`unembed_flops` adds it back. A gradient is 3 x the forward (backward =
2 x forward, no recompute).
"""
from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM data sheet: f32 outside the tensor cores (the
#: configurations state float32, TF32 off), HBM bandwidth
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

_ATTN, _LOCAL, _MAMBA, _SHARED = "attn", "attn_local", "mamba", "shared_attn"


def _kinds(cfg):
    for pattern, reps in cfg["stages"]:
        for _ in range(reps):
            yield from pattern


def _head_dim(cfg):
    return cfg.get("head_dim") or cfg["d_model"] // max(cfg["num_heads"], 1)


def param_count(cfg: Dict) -> int:
    d, hd = cfg["d_model"], _head_dim(cfg)
    n_q, n_kv = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    emb = cfg["vocab_size"] * d
    total = emb + (0 if cfg.get("tie_embeddings", True) else emb) + d
    attn = d * (n_q + 2 * n_kv) + n_q * d + (2 * hd if cfg.get("qk_norm") else 0)
    mlp = 3 * d * cfg["d_ff"]

    def mamba():
        di = cfg.get("ssm_expand", 2) * d
        N, G = cfg["ssm_state"], cfg.get("ssm_groups", 1)
        H = di // cfg["ssm_head_dim"]
        return d * (2 * di + 2 * G * N + H) \
            + (di + 2 * G * N) * cfg["ssm_conv"] + 3 * H + di * d + di

    shared = False
    for pattern, reps in cfg["stages"]:
        for kind in pattern:
            if kind in (_ATTN, _LOCAL):
                total += (attn + mlp + 2 * d) * reps
            elif kind == _MAMBA:
                total += (mamba() + d) * reps
            elif kind == _SHARED and not shared:
                total += attn + mlp + 2 * d
                shared = True
    return int(total)


def _attn_fwd(cfg, B, L, window=0):
    hd = _head_dim(cfg)
    per_q = min(window, L) if window else L / 2
    return 2 * B * L * per_q * cfg["num_heads"] * 2 * hd


def _mamba_fwd(cfg, B, L):
    di = cfg.get("ssm_expand", 2) * cfg["d_model"]
    P, N, G = cfg["ssm_head_dim"], cfg["ssm_state"], cfg.get("ssm_groups", 1)
    H, Q = di // P, min(cfg["ssm_chunk"], L)
    nc = L // Q
    return (2 * B * nc * G * Q * Q * N + 2 * B * nc * H * Q * Q * P
            + 2 * B * L * H * P * N * 2)


def forward_flops(cfg: Dict, B: int, L: int) -> float:
    """The repository's analytic forward count of one batch of B x L."""
    total = 2 * (param_count(cfg) - cfg["vocab_size"] * cfg["d_model"]) \
        * B * L
    for kind in _kinds(cfg):
        if kind == _MAMBA:
            total += _mamba_fwd(cfg, B, L)
        elif kind in (_ATTN, _LOCAL, _SHARED):
            w = cfg.get("window_size", 4096) if kind in (_LOCAL, _SHARED) else 0
            total += _attn_fwd(cfg, B, L, window=w)
    return float(total)


def unembed_flops(cfg: Dict, B: int, L: int) -> float:
    """The logits' product against a tied embedding, which
    `forward_flops` leaves out (0 for an untied one, which it counts)."""
    if not cfg.get("tie_embeddings", True):
        return 0.0
    return float(2 * cfg["vocab_size"] * cfg["d_model"] * B * L)


def gradient_flops(cfg: Dict, B: int, L: int) -> float:
    """One client gradient over a batch of B windows of L tokens."""
    return 3.0 * (forward_flops(cfg, B, L) + unembed_flops(cfg, B, L))


def quant_bytes(numel: int, rows: int = 1) -> int:
    """quantize_rows' least traffic: each f32 number read once, its int8
    code written once, one f32 scale a row written."""
    return rows * (5 * numel + 4)


def dequant_bytes(numel: int, rows: int = 1) -> int:
    """dequantize_rows': each code and scale read once, each f32 written."""
    return rows * (5 * numel + 4)
