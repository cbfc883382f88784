"""Top-level model API: build_model(cfg) -> Model with
init / forward / loss / prefill / init_cache / decode_step — a port of
`repro.models.model` for the attention-only decoders.

Batch conventions (tensors; token ids int32 or int64)
-----------------------------------------------------
train / prefill:
  {"tokens": (B, Lt), "targets": (B, L) (train only; -1 = ignore),
   "vision_embeds": (B, Np, d)           [vlm; L = Np + Lt]
   "positions3": (B, 3, L)}              [vlm M-RoPE]
decode:
  decode_step(params, cache, tokens (B,), pos) -> (logits, cache), `pos` a
  Python int or a 0-d tensor.

The encoder-decoder (the audio frontend's encoder and the decoder's
cross-attention) raises `NotImplementedError` (ROADMAP A9b-2), as do the
layer kinds and FFNs `repro_torch.models.transformer` does not carry.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import torch_dtype
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (embed_apply, embed_init, mrope_angles,
                                       rms_norm, rope_angles, unembed_apply)


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable          # (generator, device=None) -> params
    forward: Callable       # (params, batch, remat="none") -> (logits, aux)
    loss_fn: Callable       # (params, batch, remat=...) -> scalar
    prefill: Callable       # (params, batch) -> (last_logits, cache)
    init_cache: Callable    # (batch_size, max_len, device=None) -> cache
    decode_step: Callable   # (params, cache, tokens, pos) -> (logits, cache)


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim


def _angles(cfg, batch, B, L, device, offset=0):
    if cfg.attention_free:
        return None, None
    if cfg.rope_mode == "mrope" and batch is not None and "positions3" in batch:
        return mrope_angles(batch["positions3"], _rope_dim(cfg),
                            cfg.rope_theta, cfg.mrope_sections)
    pos = (torch.arange(L, dtype=torch.int32, device=device)[None]
           + offset).expand(B, L)
    return rope_angles(pos, _rope_dim(cfg), cfg.rope_theta)


def build_model(cfg: ModelConfig) -> Model:
    dtype = torch_dtype(cfg.dtype)
    if cfg.is_encoder_decoder:
        raise tf.pending("the encoder-decoder")
    for pattern, _ in cfg.stages:
        for kind in pattern:
            tf.check_kind(kind)
    if cfg.is_moe:
        raise tf.pending("the MoE FFN")

    # ---------------- init ------------------------------------------------
    def init(generator: torch.Generator, device=None):
        """The parameters, drawn from `generator` on its device (and moved
        to `device` if given): the embedding, then each stage's repeats in
        order."""
        dev = device or generator.device
        params: Dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                                device),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=dev),
        }
        params["stages"] = [
            tf.stage_init(generator, pattern, reps, cfg, dtype,
                          device=device)
            for pattern, reps in cfg.stages]
        return params

    # ---------------- shared helpers --------------------------------------
    def _embed_inputs(params, batch):
        """Returns h (B, L, d)."""
        tok = batch["tokens"]
        h = embed_apply(params["embed"], tok) * math.sqrt(cfg.d_model)
        h = h.to(dtype)
        if cfg.frontend == "vision" and "vision_embeds" in batch:
            h = torch.cat([batch["vision_embeds"].to(dtype), h], dim=1)
        return h

    def _run_stages(params, h, cos, sin, *, remat="none",
                    return_cache=False):
        aux_total = 0.0
        caches = []
        for sp, (pattern, _) in zip(params["stages"], cfg.stages):
            h, aux, cache = tf.stage_apply(
                sp, pattern, h, cos, sin, cfg, causal=True, remat=remat,
                return_cache=return_cache)
            aux_total = aux_total + aux
            caches.append(cache)
        return h, aux_total, caches

    # ---------------- forward / loss --------------------------------------
    def forward(params, batch, remat="none"):
        h = _embed_inputs(params, batch)
        B, L, _ = h.shape
        cos, sin = _angles(cfg, batch, B, L, h.device)
        h, aux, _ = _run_stages(params, h, cos, sin, remat=remat)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h,
                               logit_softcap=cfg.logit_softcap)
        return logits, aux

    def loss_fn(params, batch, remat="none"):
        """Mean next-token cross-entropy over the targets ≥ 0 (the router
        term of JAX's is 0 for every config this slice builds)."""
        logits, _ = forward(params, batch, remat=remat)
        targets = batch["targets"].long()
        mask = (targets >= 0).float()
        tgt = torch.clamp(targets, min=0)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, tgt[..., None])[..., 0] - logz
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    # ---------------- serving ---------------------------------------------
    def init_cache(batch_size: int, max_len: int, device=None):
        """Zeroed per-layer caches, one stage's leaves leading with its
        repeats (``device="meta"`` gives shapes only)."""
        caches = [tf.stage_cache_init(pattern, reps, cfg, batch_size,
                                      max_len, dtype, device)
                  for pattern, reps in cfg.stages]
        return {"layers": caches}

    def prefill(params, batch):
        h = _embed_inputs(params, batch)
        B, L, _ = h.shape
        cos, sin = _angles(cfg, batch, B, L, h.device)
        h, _, caches = _run_stages(params, h, cos, sin, return_cache=True)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h[:, -1:],
                               logit_softcap=cfg.logit_softcap)
        return logits[:, 0], caches

    def decode_step(params, cache, tokens, pos):
        B = tokens.shape[0]
        h = embed_apply(params["embed"], tokens[:, None]) * math.sqrt(
            cfg.d_model)
        h = h.to(dtype)
        p = torch.as_tensor(pos, device=h.device).to(torch.int32)
        cos, sin = rope_angles(p.reshape(1, 1).expand(B, 1), _rope_dim(cfg),
                               cfg.rope_theta)
        new_layer_caches = []
        for i, (sp, (pattern, _)) in enumerate(zip(params["stages"],
                                                   cfg.stages)):
            h, nc = tf.stage_decode(sp, pattern, h, cos, sin,
                                    cache["layers"][i], pos, cfg)
            new_layer_caches.append(nc)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h[:, 0],
                               logit_softcap=cfg.logit_softcap)
        new_cache = dict(cache)
        new_cache["layers"] = new_layer_caches
        return logits, new_cache

    return Model(cfg, init, forward, loss_fn, prefill, init_cache,
                 decode_step)
