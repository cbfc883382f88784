"""Hand-written CUDA kernel: ACED's bounded-delay aggregation over the int8
cache (port of `repro.kernels.masked_agg`, paper Alg. a.1 line 7).

    u = Σ_i m_i·s_i·C[i] / max(Σ_i m_i, 1)          (f32)

The kernel is ``csrc/masked_agg.cu``; its plain version is
`ref.masked_agg_ref` (``plain`` below), which `ops.masked_agg` takes for CPU
tensors. The kernel forms the weights ``m·s / max(Σm, 1)`` on the device
from the mask and the scales, so a call never waits for the card. Each
launch follows `_agg_plan`, computed here in plain Python: column tiles of
`FEATURES` features, one a block, staged in chunks of up to `MAX_ROWS`
rows."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.ref import masked_agg_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None

FEATURES = 128              # columns a block (and its threads), csrc kF
MAX_ROWS = 128              # rows a chunk stages at most (csrc kMaxRows)


def _agg_plan(n, d):
    """Launch plan of masked_agg for an (n, d) cache -> (rows, blocks): one
    tile of `FEATURES` columns a block, ⌈d / FEATURES⌉ blocks, the n rows
    staged `rows` at a time. A block's shared memory is
    rows·(FEATURES + 16) bytes, under the 48 KB a launch takes without
    asking."""
    return max(1, min(n, MAX_ROWS)), max(1, -(-d // FEATURES))


def masked_agg(cache, scales, mask, plan=None):
    """cache (n, d) int8; scales (n,) f32; mask (n,) bool, all on one CUDA
    device -> u (d,) f32. `plan` overrides `_agg_plan`'s. Raises on
    anything else."""
    global launches, _entry
    if not isinstance(cache, torch.Tensor) or cache.dim() != 2:
        raise ValueError("cache: expected an (n, d) tensor")
    n, d = cache.shape
    cache = cuda_operand(cache, "cache", torch.int8, (n, d))
    dev = cache.device
    scales = cuda_operand(scales, "scales", torch.float32, (n,), dev)
    mask = cuda_operand(mask, "mask", torch.bool, (n,), dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    rows, blocks = plan or _agg_plan(n, d)
    if _entry is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _entry = build.function("masked_agg", "masked_agg",
                                [P] * 4 + [I, L, I, L, P])
    build.check("masked_agg", _entry(
        cache.data_ptr(), scales.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n, d, rows, blocks, stream_handle(dev)))
    launches += 1
    return out
