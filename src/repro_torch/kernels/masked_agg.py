"""Hand-written CUDA kernel: ACED's bounded-delay aggregation over the int8
cache (port of `repro.kernels.masked_agg`, paper Alg. a.1 line 7).

    u = Σ_i m_i·s_i·C[i] / max(Σ_i m_i, 1)          (f32)

The kernel is ``csrc/masked_agg.cu``; its plain version is
`ref.masked_agg_ref` (``plain`` below), which `ops.masked_agg` takes for CPU
tensors. The kernel forms the weights ``m·s / max(Σm, 1)`` on the device
from the mask and the scales, so a call never waits for the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.ref import masked_agg_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None


def masked_agg(cache, scales, mask):
    """cache (n, d) int8; scales (n,) f32; mask (n,) bool, all on one CUDA
    device -> u (d,) f32. Raises on anything else."""
    global launches, _entry
    if not isinstance(cache, torch.Tensor) or cache.dim() != 2:
        raise ValueError("cache: expected an (n, d) tensor")
    n, d = cache.shape
    cache = cuda_operand(cache, "cache", torch.int8, (n, d))
    dev = cache.device
    scales = cuda_operand(scales, "scales", torch.float32, (n,), dev)
    mask = cuda_operand(mask, "mask", torch.bool, (n,), dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    if _entry is None:
        P = ctypes.c_void_p
        _entry = build.function("masked_agg", "masked_agg",
                                [P] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           P])
    build.check("masked_agg", _entry(
        cache.data_ptr(), scales.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n, d, stream_handle(dev)))
    launches += 1
    return out
