"""Top-level model API: build_model(cfg) -> Model with
init / forward / loss / prefill / init_cache / decode_step — a port of
`repro.models.model`.

Batch conventions (tensors; token ids int32 or int64)
-----------------------------------------------------
train / prefill:
  {"tokens": (B, Lt), "targets": (B, L) (train only; -1 = ignore),
   "vision_embeds": (B, Np, d)           [vlm; L = Np + Lt]
   "positions3": (B, 3, L)               [vlm M-RoPE]
   "audio_embeds": (B, Ls, d)}           [audio enc-dec]
decode:
  decode_step(params, cache, tokens (B,), pos) -> (logits, cache), `pos` a
  Python int or a 0-d tensor.
  enc-dec decode additionally reads cache["cross"] (per-layer encoder K/V),
  which `init_cache` zero-fills and nothing fills, as in the JAX package:
  decode attends over zeros and ignores the encoder (ROADMAP C13).

Placed arguments (DTensors, `repro_torch.sharding.place.place_train` /
`place_prefill` / `place_decode`) run the same functions laid out by the
specs: each entry point runs where the plain tensors it makes (positions,
rope angles, masks) meet placed ones as replicated (`placed_scope`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ATTN, SHARED_ATTN, ModelConfig
from repro_torch.configs.registry import torch_dtype
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (embed_apply, embed_init, mrope_angles,
                                       rms_norm, rope_angles, unembed_apply)
from repro_torch.sharding.place import placed_scope
from repro_torch.sharding.rules import settle, shard


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
    has_shared = any(SHARED_ATTN in p for p, _ in cfg.stages)

    # ---------------- init ------------------------------------------------
    def init(generator: torch.Generator, device=None):
        """The parameters, drawn from `generator` on its device (and moved
        to `device` if given): the embedding, each stage's repeats in
        order, the shared block, the encoder."""
        dev = device or generator.device
        params: Dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                                device),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=dev),
        }
        params["stages"] = [
            tf.stage_init(generator, pattern, reps, cfg, dtype,
                          cross=cfg.is_encoder_decoder, device=device)
            for pattern, reps in cfg.stages]
        if has_shared:
            params["shared_block"] = tf._attn_block_init(
                generator, cfg, dtype, cross=False, device=device)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "stage": tf.stage_init(generator, (ATTN,),
                                       cfg.num_encoder_layers, cfg, dtype,
                                       device=device),
                "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                          device=dev),
            }
        return params

    # ---------------- shared helpers --------------------------------------
    def _embed_inputs(params, batch):
        """Returns h (B, L, d)."""
        tok = batch["tokens"]
        h = embed_apply(params["embed"], tok) * math.sqrt(cfg.d_model)
        h = h.to(dtype)
        if cfg.frontend == "vision" and "vision_embeds" in batch:
            h = torch.cat([batch["vision_embeds"].to(dtype), h], dim=1)
        return shard(h, ("batch", "seq", "embed"))

    def _run_encoder(params, batch, remat):
        src = batch["audio_embeds"].to(dtype)
        B, Ls, _ = src.shape
        cos, sin = _angles(cfg, None, B, Ls, src.device)
        h, _, _ = tf.stage_apply(params["encoder"]["stage"], (ATTN,), src,
                                 cos, sin, cfg, causal=False, remat=remat)
        return rms_norm(h, params["encoder"]["final_norm"], cfg.norm_eps)

    def _run_stages(params, h, cos, sin, *, enc_out=None, remat="none",
                    return_cache=False):
        shared = params.get("shared_block")
        aux_total = 0.0
        caches = []
        for sp, (pattern, _) in zip(params["stages"], cfg.stages):
            h, aux, cache = tf.stage_apply(
                sp, pattern, h, cos, sin, cfg, causal=True, enc_out=enc_out,
                shared=shared, remat=remat, return_cache=return_cache)
            aux_total = aux_total + aux
            caches.append(cache)
        return h, aux_total, caches

    # ---------------- forward / loss --------------------------------------
    def forward(params, batch, remat="none"):
        with placed_scope(params):
            return _forward(params, batch, remat)

    def _forward(params, batch, remat):
        enc_out = (_run_encoder(params, batch, remat)
                   if cfg.is_encoder_decoder else None)
        h = _embed_inputs(params, batch)
        B, L, _ = h.shape
        cos, sin = _angles(cfg, batch, B, L, h.device)
        h, aux, _ = _run_stages(params, h, cos, sin, enc_out=enc_out,
                                remat=remat)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h,
                               logit_softcap=cfg.logit_softcap)
        return logits, aux

    def loss_fn(params, batch, remat="none"):
        """Mean next-token cross-entropy over the targets ≥ 0, plus
        ``router_aux_weight`` × the MoE layers' summed load-balance loss
        (a MoE model's only: every other's aux is 0)."""
        with placed_scope(params):
            return _loss(params, batch, remat)

    def _loss(params, batch, remat):
        logits, aux = _forward(params, batch, remat)
        targets = batch["targets"].long()
        mask = (targets >= 0).float()
        tgt = torch.clamp(targets, min=0)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        # vocab-parallel on placed logits: the picked logit is summed over
        # ``model`` before it is indexed
        ll = settle(torch.gather(logits, -1, tgt[..., None]))[..., 0] - logz
        loss = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if cfg.is_moe:
            loss = loss + cfg.router_aux_weight * aux
        return loss

    # ---------------- serving ---------------------------------------------
    def init_cache(batch_size: int, max_len: int, device=None):
        """Zeroed per-layer caches, one stage's leaves leading with its
        repeats (``device="meta"`` gives shapes only); an encoder-decoder's
        also the per-layer encoder K/V, zeros that nothing fills (C13)."""
        caches = [tf.stage_cache_init(pattern, reps, cfg, batch_size,
                                      max_len, dtype, device)
                  for pattern, reps in cfg.stages]
        out = {"layers": caches}
        if cfg.is_encoder_decoder:
            S = max(1, max_len // cfg.encoder_frames_ratio)
            shape = (batch_size, S, cfg.num_kv_heads, cfg.head_dim)
            out["cross"] = [
                ({"k": torch.zeros((reps,) + shape, dtype=dtype,
                                   device=device),
                  "v": torch.zeros((reps,) + shape, dtype=dtype,
                                   device=device)},)
                for _, reps in cfg.stages]
        return out

    def prefill(params, batch):
        with placed_scope(params):
            return _prefill(params, batch)

    def _prefill(params, batch):
        enc_out = (_run_encoder(params, batch, "none")
                   if cfg.is_encoder_decoder else None)
        h = _embed_inputs(params, batch)
        B, L, _ = h.shape
        cos, sin = _angles(cfg, batch, B, L, h.device)
        h, _, caches = _run_stages(params, h, cos, sin, enc_out=enc_out,
                                   return_cache=True)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h[:, -1:],
                               logit_softcap=cfg.logit_softcap)
        return logits[:, 0], caches

    def decode_step(params, cache, tokens, pos):
        with placed_scope(params):
            return _decode_step(params, cache, tokens, pos)

    def _decode_step(params, cache, tokens, pos):
        B = tokens.shape[0]
        h = embed_apply(params["embed"], tokens[:, None]) * math.sqrt(
            cfg.d_model)
        h = h.to(dtype)
        if cfg.attention_free:
            cos = sin = None
        else:
            p = torch.as_tensor(pos, device=h.device).to(torch.int32)
            cos, sin = rope_angles(p.reshape(1, 1).expand(B, 1),
                                   _rope_dim(cfg), cfg.rope_theta)
        shared = params.get("shared_block")
        new_layer_caches = []
        for i, (sp, (pattern, _)) in enumerate(zip(params["stages"],
                                                   cfg.stages)):
            cross = cache["cross"][i] if cfg.is_encoder_decoder else None
            h, nc = tf.stage_decode(sp, pattern, h, cos, sin,
                                    cache["layers"][i], pos, cfg,
                                    shared=shared, cross_caches=cross)
            new_layer_caches.append(nc)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], h[:, 0],
                               logit_softcap=cfg.logit_softcap)
        new_cache = dict(cache)
        new_cache["layers"] = new_layer_caches
        return logits, new_cache

    return Model(cfg, init, forward, loss_fn, prefill, init_cache,
                 decode_step)
