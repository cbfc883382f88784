"""Analytic FLOP and byte counts per (arch × shape × mode) — the port of
`repro.launch.analytic`, pure arithmetic on the port's `ModelConfig` and
`InputShape`: the numerator of a FLOP/s or MFU share on the real models.

Conventions:
  * matmul fwd flops = 2·M·N·K; backward = 2× forward; full remat adds one
    forward recompute (total = 4×fwd for remat="full", 3×fwd for "none").
  * causal attention counts the ~L/2 useful half (the models mask a full
    L×L sweep, so a measured rate over this count understates the work
    the card does).
  * decode counts a single-token step against a seq_len-deep cache.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA,
                                      SHARED_ATTN, InputShape, ModelConfig)

BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def _layer_kinds(cfg: ModelConfig):
    for pattern, reps in cfg.stages:
        for _ in range(reps):
            for kind in pattern:
                yield kind


def attn_flops_fwd(cfg, B, L, *, window=0, causal=True, kv_len=None):
    """Score+value einsum flops (projections counted via params)."""
    hd = cfg.head_dim if not cfg.use_mla else (cfg.qk_nope_head_dim
                                               + cfg.qk_rope_head_dim)
    vd = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    S = kv_len if kv_len is not None else L
    if window:
        per_q = min(window, S)
    elif causal and kv_len is None:
        per_q = S / 2
    else:
        per_q = S
    return 2 * B * L * per_q * cfg.num_heads * (hd + vd)


def mamba_flops_fwd(cfg, B, L):
    """SSD chunked: intra-chunk quadratic + state in/out (projections via params)."""
    H, P, N, G, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_groups, cfg.ssm_chunk)
    Q = min(Q, L)
    nc = L // Q
    cb = 2 * B * nc * G * Q * Q * N               # C·Bᵀ
    diag = 2 * B * nc * H * Q * Q * P             # scores·x
    states = 2 * B * L * H * P * N * 2            # build + consume state
    return cb + diag + states


def param_matmul_flops_fwd(cfg, tokens):
    """2 × active-params × tokens (embedding lookups excluded, unembed included)."""
    active = cfg.active_param_count()
    emb = cfg.vocab_size * cfg.d_model   # lookup, not matmul
    return 2 * (active - emb) * tokens


def forward_flops(cfg: ModelConfig, B: int, L: int, *, mode="train") -> float:
    tokens = B * L
    total = param_matmul_flops_fwd(cfg, tokens)
    for kind in _layer_kinds(cfg):
        if kind == MAMBA:
            total += mamba_flops_fwd(cfg, B, L)
        elif kind in (ATTN, ATTN_LOCAL, SHARED_ATTN):
            w = cfg.window_size if kind in (ATTN_LOCAL, SHARED_ATTN) else 0
            total += attn_flops_fwd(cfg, B, L, window=w)
    if cfg.is_encoder_decoder:
        Ls = L // cfg.encoder_frames_ratio
        enc_tokens = B * Ls
        # encoder matmuls counted in params already (active_param_count covers
        # encoder params); approximate their token count difference:
        total += cfg.num_encoder_layers * attn_flops_fwd(cfg, B, Ls, causal=False)
        total += cfg.num_layers * attn_flops_fwd(cfg, B, L, kv_len=Ls)  # cross
    return float(total)


def decode_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """One token per sequence against an S-deep cache."""
    total = param_matmul_flops_fwd(cfg, B)
    for kind in _layer_kinds(cfg):
        if kind == MAMBA:
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            total += 2 * B * H * P * N * 2
        else:
            w = cfg.window_size if kind in (ATTN_LOCAL, SHARED_ATTN) else 0
            kv = min(w, S) if w else S
            total += attn_flops_fwd(cfg, B, 1, kv_len=kv, causal=False)
    if cfg.is_encoder_decoder:
        total += cfg.num_layers * attn_flops_fwd(
            cfg, B, 1, kv_len=S // cfg.encoder_frames_ratio, causal=False)
    return float(total)


def analytic_costs(cfg: ModelConfig, shape: InputShape, *, mode=None,
                   remat="full", afl=None) -> Dict[str, float]:
    mode = mode or shape.mode
    B, L = shape.global_batch, shape.seq_len
    pb = BYTES[cfg.dtype]
    params = cfg.param_count()
    out: Dict[str, float] = {}
    if mode in ("train", "prefill"):
        fwd = forward_flops(cfg, B, L, mode=mode)
        if mode == "train":
            factor = {"none": 3.0, "dots": 3.34, "full": 4.0}[remat]
            out["flops"] = fwd * factor
        else:
            out["flops"] = fwd
        tokens = B * L
        # memory: weight streams + activation streams (~14 d-vectors/layer/tok)
        w_reads = {"train": 3, "prefill": 1}[mode] + (1 if remat == "full" and
                                                      mode == "train" else 0)
        bytes_ = params * pb * w_reads
        if mode == "train":
            bytes_ += params * 4 * 2          # f32 grad write + optimizer read
        bytes_ += 14 * tokens * cfg.d_model * pb * cfg.num_layers
        bytes_ += 2 * tokens * cfg.vocab_size * pb  # logits round-trip
        if mode == "train" and afl is not None:
            cb = BYTES[afl.cache_dtype]
            sb = BYTES[afl.state_dtype]
            if afl.algorithm == "ace":
                # Alg a.5: row read+write + running-mean read+write — O(d)
                bytes_ += params * (2 * cb + 2 * sb)
            elif afl.algorithm in ("ace_direct", "aced"):
                # Alg 1 / a.1: full-cache read every arrival — O(n d)
                bytes_ += params * ((afl.n_clients + 1) * cb + 4)
            elif afl.algorithm == "ca2fl":
                bytes_ += params * (2 * cb + 6 * sb)
            elif afl.algorithm == "fedbuff":
                bytes_ += params * 4 * sb
        out["bytes"] = float(bytes_)
    else:  # decode
        out["flops"] = decode_flops(cfg, B, L)
        bytes_ = params * pb                   # full weight stream per token
        for kind in _layer_kinds(cfg):
            if kind == MAMBA:
                bytes_ += B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
            elif cfg.use_mla:
                bytes_ += B * L * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * pb
            else:
                w = cfg.window_size if kind in (ATTN_LOCAL, SHARED_ATTN) else 0
                kv = min(w, L) if w else L
                bytes_ += 2 * B * kv * cfg.num_kv_heads * cfg.head_dim * pb
        out["bytes"] = float(bytes_)
    return out
