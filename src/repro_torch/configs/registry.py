"""Architecture registry: --arch lookup, per-shape input specs
(meta-device stand-ins, zero allocation), shape-support rules, and
per-arch AFL server sizing (client count / cache dtype chosen so the O(nd)
cache fits the production pod) — a copy of `repro.configs.registry`, with
``torch.empty(shape, dtype=..., device="meta")`` in place of
``jax.ShapeDtypeStruct``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import (arctic_480b, gemma2_2b, llama3_405b,
                                 mamba2_780m, minicpm3_4b, qwen2_vl_7b,
                                 qwen3_moe_235b_a22b, seamless_m4t_medium,
                                 yi_9b, zamba2_1p2b)
from repro_torch.configs.base import (INPUT_SHAPES, AFLConfig, InputShape,
                                      ModelConfig)
from repro_torch.convert import tree_map
from repro_torch.kernels.backend import resolve_device

ARCHS: Dict[str, ModelConfig] = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "zamba2-1.2b": zamba2_1p2b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
}

# Which archs run long_500k (sub-quadratic requirement).
LONG_CONTEXT_OK = {"mamba2-780m", "zamba2-1.2b", "gemma2-2b"}

# Per-arch AFL server sizing: the ACE cache is O(n_clients · params);
# big archs use the paper's int8 compression (F.3.3) + bf16 running mean.
AFL_SIZING = {
    "llama3-405b": dict(n_clients=2, cache_dtype="int8", state_dtype="bfloat16"),
    "arctic-480b": dict(n_clients=2, cache_dtype="int8", state_dtype="bfloat16"),
    "qwen3-moe-235b-a22b": dict(n_clients=4, cache_dtype="int8",
                                state_dtype="bfloat16"),
    "qwen2-vl-7b": dict(n_clients=16, cache_dtype="int8"),
    "yi-9b": dict(n_clients=16, cache_dtype="int8"),
    "minicpm3-4b": dict(n_clients=16, cache_dtype="int8"),
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string as a torch dtype."""
    return DTYPES[name]


def get_config(arch: str, *, shape: Optional[str] = None,
               dtype: Optional[str] = None) -> ModelConfig:
    """Resolve an arch id (+ shape-specific variant swaps) to a ModelConfig."""
    cfg = ARCHS[arch]
    if arch == "gemma2-2b" and shape == "long_500k":
        cfg = gemma2_2b.swa_variant()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def afl_config(arch: str, **over) -> AFLConfig:
    kw = dict(AFL_SIZING.get(arch, dict(n_clients=16, cache_dtype="float32")))
    kw.update(over)
    return AFLConfig(**kw)


def supports_shape(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


def skip_reason(arch: str, shape: str) -> str:
    if not supports_shape(arch, shape):
        return ("full-attention arch; long_500k requires sub-quadratic decode "
                "(see DESIGN.md §Arch-applicability)")
    return ""


# ---------------------------------------------------------------------------
# Input specs: meta-device stand-ins for every model input
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape | str,
                batch_override: Optional[int] = None) -> Dict:
    """Batch spec for train/prefill; (tokens, pos, cache) for decode: each
    input as a tensor on the meta device (its shape and dtype, no
    storage)."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    B = batch_override or shape.global_batch
    L = shape.seq_len
    act_dt = torch_dtype(cfg.dtype)

    if shape.mode in ("train", "prefill"):
        batch = {}
        if cfg.frontend == "vision":
            np_ = cfg.num_patches
            batch["tokens"] = _meta((B, L - np_), torch.int32)
            batch["vision_embeds"] = _meta((B, np_, cfg.d_model), act_dt)
            batch["positions3"] = _meta((B, 3, L), torch.int32)
        elif cfg.frontend == "audio":
            batch["audio_embeds"] = _meta((B, L // cfg.encoder_frames_ratio,
                                           cfg.d_model), act_dt)
            batch["tokens"] = _meta((B, L), torch.int32)
        else:
            batch["tokens"] = _meta((B, L), torch.int32)
        if shape.mode == "train":
            batch["targets"] = _meta((B, L), torch.int32)
        return {"batch": batch}

    # decode: single token against a seq_len-deep cache
    from repro_torch.models import build_model  # late import to avoid cycles
    model = build_model(cfg)
    cache = model.init_cache(B, L, device="meta")
    return {"tokens": _meta((B,), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": cache}


def concrete_batch(cfg: ModelConfig, shape: InputShape | str, rng=None,
                   batch_override: Optional[int] = None, device=None):
    """Materialize a random batch matching input_specs (smoke tests and
    examples), drawn from ``np.random.default_rng`` leaf by leaf in JAX's
    leaf order, so that the JAX package's gives the same arrays. On the
    GPU unless ``device="cpu"``."""
    device = resolve_device(device)
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    specs = input_specs(cfg, shape, batch_override)
    rng = np.random.default_rng(0 if rng is None else rng)

    def mk(s):
        if s.dtype == torch.int32:
            hi = cfg.vocab_size if s.shape and s.shape[-1] != 3 else 4
            a = rng.integers(0, min(hi, cfg.vocab_size), size=tuple(s.shape))
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        a = rng.normal(size=tuple(s.shape)) * 0.05
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(s.dtype)
    return tree_map(mk, specs)
