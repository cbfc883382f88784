"""Config-driven transformer stack — a port of `repro.models.transformer`.

A model is a sequence of *stages*; each stage is (pattern, repeats) where
the pattern is a tuple of layer kinds. A stage's parameters are JAX's: a
tuple, one entry per pattern kind, of dicts whose leaves lead with the
stage's `repeats` axis (JAX's ``vmap``'d unit init), so a JAX model's
parameters carry across as a plain structural copy and the tree layout's
leaf order is JAX's. Where JAX scans over the repeats, the port loops over
them in Python, indexing ``leaf[r]`` (``cfg.scan_layers`` changes
nothing).

Supported kinds: attn, attn_local (sliding window), mamba (SSD) and
shared_attn (Zamba2-style: one attention+MLP unit whose parameters live at
model level, windowed; its entry in a stage is ``{}``). Dense FFN / MoE
FFN (with arctic's parallel dense residual) and MLA vs GQA are chosen from
the config. Encoder-decoder adds per-decoder-layer cross-attention. The
JAX package's sharding constraints are not ported (multi-GPU is ROADMAP
A10)."""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ATTN_LOCAL, MAMBA, SHARED_ATTN, ModelConfig
from repro_torch.convert import leaves, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def _attn_block_init(generator, cfg: ModelConfig, dtype, *, cross: bool,
                     device=None):
    dev = device or generator.device
    p: Dict[str, Any] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
    if cfg.use_mla:
        p["attn"] = attn_lib.mla_init(generator, cfg, dtype, device)
    else:
        p["attn"] = attn_lib.attn_init(generator, cfg, dtype, device)
    if cfg.is_moe:
        p["ffn"] = moe_lib.moe_init(generator, cfg, dtype, device)
        if cfg.dense_residual:
            p["dense_ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                      dtype, device)
    else:
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)
    if cross:
        p["ln_c"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
        p["cross"] = attn_lib.attn_init(generator, cfg, dtype, device)
    return p


def block_init(generator, kind: str, cfg: ModelConfig, dtype, *,
               cross: bool = False, device=None):
    if kind == MAMBA:
        dev = device or generator.device
        return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
                "mamba": ssm_lib.mamba_init(generator, cfg, dtype, device)}
    if kind == SHARED_ATTN:
        return {}            # parameters live at model level (shared)
    return _attn_block_init(generator, cfg, dtype, cross=cross,
                            device=device)


def _ffn_apply(params, x, cfg):
    if cfg.is_moe:
        y, aux = moe_lib.moe_apply(params["ffn"], x, cfg)
        if cfg.dense_residual:
            y = y + mlp_apply(params["dense_ffn"], x)
        return y, aux
    return mlp_apply(params["ffn"], x), 0.0


def _window(kind, cfg):
    return cfg.window_size if kind in (ATTN_LOCAL, SHARED_ATTN) else 0


def block_apply(params, kind, x, cos, sin, cfg, *, causal=True, enc_out=None,
                shared=None, return_cache=False):
    """Full-sequence (train / prefill) block. Returns (x, aux, cache|None)."""
    if kind == MAMBA:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y = ssm_lib.mamba_apply(params["mamba"], h, cfg)
        return x + y, 0.0, None
    if kind == SHARED_ATTN:
        params = shared
    window = _window(kind, cfg)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    cache = None
    if cfg.use_mla:
        y = attn_lib.mla_apply(params["attn"], h, cos, sin, cfg,
                               causal=causal, window=window)
    elif return_cache:
        y, cache = attn_lib.attn_apply(params["attn"], h, cos, sin, cfg,
                                       causal=causal, window=window,
                                       return_kv=True)
    else:
        y = attn_lib.attn_apply(params["attn"], h, cos, sin, cfg,
                                causal=causal, window=window)
    x = x + y
    if enc_out is not None:
        h = rms_norm(x, params["ln_c"], cfg.norm_eps)
        y = attn_lib.attn_apply(params["cross"], h, None, None, cfg,
                                causal=False, kv_x=enc_out)
        x = x + y
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    y, aux = _ffn_apply(params, h, cfg)
    return x + y, aux, cache


def block_decode(params, kind, x, cos, sin, cache, pos, cfg, *, shared=None,
                 cross_cache=None):
    """Single-token decode. x (B,1,d). Returns (x, new_cache)."""
    if kind == MAMBA:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, new_cache = ssm_lib.mamba_decode(params["mamba"], h, cache, cfg)
        return x + y, new_cache
    if kind == SHARED_ATTN:
        params = shared
    window = _window(kind, cfg)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        y, new_cache = attn_lib.mla_decode(params["attn"], h, cos, sin, cache,
                                           pos, cfg)
    else:
        y, new_cache = attn_lib.attn_decode(params["attn"], h, cos, sin,
                                            cache, pos, cfg, window=window)
    x = x + y
    if cross_cache is not None:
        # the encoder's K/V as the cache holds them (JAX's: zeros, never
        # filled — ROADMAP C13)
        h = rms_norm(x, params["ln_c"], cfg.norm_eps)
        B = x.shape[0]
        q = (h @ params["cross"]["wq"]).reshape(B, 1, cfg.num_heads,
                                                cfg.head_dim)
        valid = torch.ones((B, cross_cache["k"].shape[1]), dtype=torch.bool,
                           device=x.device)
        y = attn_lib.decode_attention(q[:, 0], cross_cache["k"],
                                      cross_cache["v"], valid)
        x = x + y.reshape(B, 1, -1) @ params["cross"]["wo"]
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    y, _ = _ffn_apply(params, h, cfg)
    return x + y, new_cache


def block_cache_init(kind, cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None):
    if kind == MAMBA:
        return ssm_lib.mamba_init_cache(cfg, batch, dtype, device)
    S = max_len
    if kind in (ATTN_LOCAL, SHARED_ATTN) and cfg.window_size:
        S = min(cfg.window_size, max_len)
    if cfg.use_mla:
        return {"latent": torch.zeros((batch, S, cfg.kv_lora_rank),
                                      dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, S, cfg.qk_rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Stage (a loop over repeated pattern units)
# ---------------------------------------------------------------------------

def _stack(units):
    """Per-repeat structures -> one structure whose leaves lead with the
    repeats (JAX's ``vmap`` / ``scan`` output)."""
    return tree_map(lambda *xs: torch.stack(xs), units[0], *units[1:])


def stage_init(generator, pattern, repeats, cfg, dtype, *, cross=False,
               device=None):
    units = [tuple(block_init(generator, kind, cfg, dtype, cross=cross,
                              device=device) for kind in pattern)
             for _ in range(repeats)]
    return _stack(units)


def _unit(r):
    """Repeat `r` of a stage's parameters (views)."""
    return lambda stage: tree_map(lambda x: x[r], stage)


def _save_matmuls(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    un-batched matrix products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def stage_apply(stage_params, pattern, x, cos, sin, cfg, *, causal=True,
                enc_out=None, shared=None, remat="full", return_cache=False):
    """The stage's repeats in order: each unit's blocks on the running
    activation. ``remat="full"`` recomputes a unit in the backward pass
    (`torch.utils.checkpoint`), ``"dots"`` saves only its matrix products'
    outputs (selective checkpointing), ``"none"`` saves everything.
    Returns (x, aux, caches): caches per pattern kind, leaves leading with
    the repeats (with `return_cache`), else None."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: one of 'none', 'full', 'dots'")

    def unit(h, unit_params):
        aux, caches = 0.0, []
        for bp, kind in zip(unit_params, pattern):
            h, a, c = block_apply(bp, kind, h, cos, sin, cfg, causal=causal,
                                  enc_out=enc_out, shared=shared,
                                  return_cache=return_cache)
            aux = aux + a
            caches.append(c)
        return h, aux, tuple(caches)

    repeats = stage_params_len(stage_params)
    aux_total, per_repeat = 0.0, []
    for r in range(repeats):
        unit_params = _unit(r)(stage_params)
        if remat == "none" or not torch.is_grad_enabled():
            x, aux, caches = unit(x, unit_params)
        else:
            kw = {}
            if remat == "dots":
                kw["context_fn"] = functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    _save_matmuls)
            x, aux, caches = ckpt.checkpoint(unit, x, unit_params,
                                             use_reentrant=False, **kw)
        aux_total = aux_total + aux
        per_repeat.append(caches)
    if not return_cache:
        return x, aux_total, None
    stacked = tuple(None if per_repeat[0][i] is None
                    else _stack([c[i] for c in per_repeat])
                    for i in range(len(pattern)))
    return x, aux_total, stacked


def stage_decode(stage_params, pattern, x, cos, sin, stage_cache, pos, cfg,
                 *, shared=None, cross_caches=None):
    """One token through the stage's repeats. `cross_caches` (the
    encoder-decoder's) is per pattern kind, leaves leading with the
    repeats, like `stage_cache`; it is read, not returned."""
    new_units = []
    for r in range(stage_params_len(stage_params)):
        unit_params = _unit(r)(stage_params)
        unit_cache = _unit(r)(stage_cache)
        unit_cross = (_unit(r)(cross_caches) if cross_caches is not None
                      else (None,) * len(pattern))
        new = []
        for i, (bp, kind) in enumerate(zip(unit_params, pattern)):
            x, nc = block_decode(bp, kind, x, cos, sin, unit_cache[i], pos,
                                 cfg, shared=shared,
                                 cross_cache=unit_cross[i])
            new.append(nc)
        new_units.append(tuple(new))
    return x, _stack(new_units)


def stage_cache_init(pattern, repeats, cfg, batch, max_len, dtype,
                     device=None):
    one = tuple(block_cache_init(kind, cfg, batch, max_len, dtype, device)
                for kind in pattern)
    return tree_map(lambda a: a[None].repeat((repeats,) + (1,) * a.dim()),
                    one)


def stage_params_len(stage_params) -> int:
    return leaves(stage_params)[0].shape[0]
