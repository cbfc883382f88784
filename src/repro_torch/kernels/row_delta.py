"""Hand-written CUDA kernel: fused int8 cache-row swap for the incremental
running-sum rules (port of `repro.kernels.row_delta`).

    delta  = q(g)·new_scale − c_row·old_scale      (f32)
    c_row' = q(g)                                  (int8)

The kernel is ``csrc/row_delta.cu``; its plain version is
`ref.row_delta_ref` (``plain`` below), which `ops.row_delta` takes for CPU
tensors. The scales are device tensors, read by the kernel through
pointers, so a call never waits for the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import (cuda_operand, cuda_scalar,
                                         stream_handle)
from repro_torch.kernels.ref import row_delta_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None


def row_delta(g, c_row, old_scale, new_scale):
    """g (d,) f32; c_row (d,) int8; old_scale, new_scale 0-d f32, all on one
    CUDA device -> (delta (d,) f32, c_row' (d,) int8). Raises on anything
    else."""
    global launches, _entry
    d = g.shape[0] if isinstance(g, torch.Tensor) and g.dim() == 1 else -1
    g = cuda_operand(g, "g", torch.float32, (d,))
    dev = g.device
    c_row = cuda_operand(c_row, "c_row", torch.int8, (d,), dev)
    old_scale = cuda_scalar(old_scale, "old_scale", dev)
    new_scale = cuda_scalar(new_scale, "new_scale", dev)
    delta = torch.empty((d,), dtype=torch.float32, device=dev)
    c_out = torch.empty((d,), dtype=torch.int8, device=dev)
    if _entry is None:
        P = ctypes.c_void_p
        _entry = build.function("row_delta", "row_delta",
                                [P] * 6 + [ctypes.c_longlong, P])
    build.check("row_delta", _entry(
        g.data_ptr(), c_row.data_ptr(), old_scale.data_ptr(),
        new_scale.data_ptr(), delta.data_ptr(), c_out.data_ptr(), d,
        stream_handle(dev)))
    launches += 1
    return delta, c_out
