"""Hand-written CUDA kernel: fused ACE incremental cache-row update (port of
`repro.kernels.cache_update`, paper Alg. a.5 with the App. F.3.3 int8
cache).

    u'     = u + (q(g)·new_scale − c_row·old_scale)·inv_n
    c_row' = q(g)                                   (int8)

The kernel is ``csrc/cache_update.cu``; its plain version is
`ref.cache_row_update_ref` (``plain`` below), which `ops.cache_row_update`
takes for CPU tensors. The three scalars are device tensors, read by the
kernel through pointers, so a call never waits for the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import (cuda_operand, cuda_scalar,
                                         stream_handle)
from repro_torch.kernels.ref import cache_row_update_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None


def cache_row_update(u, g, c_row, old_scale, new_scale, inv_n):
    """u, g (d,) f32; c_row (d,) int8; old_scale, new_scale, inv_n 0-d f32,
    all on one CUDA device -> (u' (d,) f32, c_row' (d,) int8). Raises on
    anything else."""
    global launches, _entry
    d = u.shape[0] if isinstance(u, torch.Tensor) and u.dim() == 1 else -1
    u = cuda_operand(u, "u", torch.float32, (d,))
    dev = u.device
    g = cuda_operand(g, "g", torch.float32, (d,), dev)
    c_row = cuda_operand(c_row, "c_row", torch.int8, (d,), dev)
    old_scale = cuda_scalar(old_scale, "old_scale", dev)
    new_scale = cuda_scalar(new_scale, "new_scale", dev)
    inv_n = cuda_scalar(inv_n, "inv_n", dev)
    u_out = torch.empty((d,), dtype=torch.float32, device=dev)
    c_out = torch.empty((d,), dtype=torch.int8, device=dev)
    if _entry is None:
        P = ctypes.c_void_p
        _entry = build.function("cache_update", "cache_row_update",
                                [P] * 8 + [ctypes.c_longlong, P])
    build.check("cache_update", _entry(
        u.data_ptr(), g.data_ptr(), c_row.data_ptr(), old_scale.data_ptr(),
        new_scale.data_ptr(), inv_n.data_ptr(), u_out.data_ptr(),
        c_out.data_ptr(), d, stream_handle(dev)))
    launches += 1
    return u_out, c_out
