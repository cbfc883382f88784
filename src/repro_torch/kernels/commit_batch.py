"""Hand-written CUDA kernel: the fused K-arrival server commit (port of
`repro.kernels.commit_batch`).

One pass over the features performs the whole batched commit that
`Aggregator.step_batch` otherwise spells as an op chain
(`cache_set_rows_delta` + masked segment sums + running-sum/update maps):

    dequantize the K old cache rows           old_k = C[k]·old_s_k
    requantize the K new rows                 C'[k] = q(Ĝ_k)   (valid lanes)
    masked segment sums                       S_Δ, S_A, S_B, S_G
    running sums + model update               [V'; u] = mats @ [V; S_*]

The per-lane scalars (`old_s`, `new_s`, `valid`, the lane weights) and
the recombination (`coef`, `upd_w`) travel as their own device tensors,
absent ones as null pointers, and the kernel stages them in shared
memory: a call launches the kernel and nothing else. The kernel is
``csrc/commit_batch.cu``; its plain version is `ref.commit_batch_ref`
(``plain`` below), which `ops.commit_batch` takes for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.ref import commit_batch_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None
_ROW_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _ptr(x):
    """A device pointer for the C entry; None (a null pointer) for an
    absent operand."""
    return None if x is None else x.data_ptr()


def commit_batch(G, old_rows, old_s, new_s, valid, vecs, coef, upd_w,
                 lane_a=None, lane_b=None, lane_g=None):
    """Fused batched commit on one CUDA device; same signature and semantics
    as `ref.commit_batch_ref` -> ``(new_rows (K, d), vecs' (R, d) f32,
    update (d,) f32)``.

    `old_s`/`new_s` are (K,) f32 for an int8 cache, None for float caches;
    `lane_a`/`lane_b`/`lane_g` are optional (K,) f32 lane weights (zero on
    invalid lanes) — None compiles that segment sum out of the kernel.
    Raises on operands the kernel does not take."""
    global launches, _entry
    if not isinstance(G, torch.Tensor) or G.dim() != 2:
        raise ValueError("G: expected a (K, d) tensor")
    K, d = G.shape
    G = cuda_operand(G, "G", torch.float32, (K, d))
    dev = G.device
    if old_rows.dtype not in _ROW_TYPES:
        raise TypeError(f"old_rows: dtype {old_rows.dtype} is not int8, "
                        "bf16 or f32")
    old_rows = cuda_operand(old_rows, "old_rows", old_rows.dtype, (K, d), dev)
    R = vecs.shape[0] if vecs.dim() == 2 else -1
    vecs = cuda_operand(vecs, "vecs", torch.float32, (R, d), dev)
    cuda_operand(valid, "valid", torch.bool, (K,), dev)
    cuda_operand(coef, "coef", torch.float32, (R, R + 4), dev)
    cuda_operand(upd_w, "upd_w", torch.float32, (R + 4,), dev)
    quantized = old_rows.dtype == torch.int8
    if quantized:
        cuda_operand(old_s, "old_s", torch.float32, (K,), dev)
        cuda_operand(new_s, "new_s", torch.float32, (K,), dev)
    elif old_s is not None or new_s is not None:
        raise ValueError("old_s/new_s are for int8 rows only")
    for name, w in (("lane_a", lane_a), ("lane_b", lane_b),
                    ("lane_g", lane_g)):
        if w is not None:
            cuda_operand(w, name, torch.float32, (K,), dev)
    new_rows = torch.empty_like(old_rows)
    vecs_out = torch.empty((R, d), dtype=torch.float32, device=dev)
    update = torch.empty((d,), dtype=torch.float32, device=dev)
    if _entry is None:
        P = ctypes.c_void_p
        _entry = build.function(
            "commit_batch", "commit_batch",
            [ctypes.c_int] + [P] * 14
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, P])
    build.check("commit_batch", _entry(
        _ROW_TYPES[old_rows.dtype],
        *(_ptr(x) for x in (G, old_rows, old_s, new_s, valid, lane_a, lane_b,
                            lane_g, coef, upd_w, vecs, new_rows, vecs_out,
                            update)),
        K, R, d, stream_handle(dev)))
    launches += 1
    return new_rows, vecs_out, update
