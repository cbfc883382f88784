"""Hand-written CUDA kernel: the whole int8 ACE incremental step in one
launch (port of `repro.kernels.cache_update`, paper Alg. a.5 with the App.
F.3.3 int8 cache, and of the gather, scale and scatter that
`ACEIncremental.step` fuses around it on the TPU).

    s = row_scale(g),  u' = u + (q(g)·s − dq(data[j]))·inv_n
    data[j] = q(g),  scale[j] = s                    (in place)

The kernel is ``csrc/cache_update.cu``; its plain version is
`ref.set_row_ace_ref` (``plain`` below), which `ops.cache_row_update` takes
for CPU tensors. The row index is a device tensor, read by the kernel, and
inv_n a value of the launch, so a call never waits for the card. u (f32 or
bf16) is read, never written: u' is a fresh tensor of u's dtype. The launch
plan (`_ace_plan`) is the row swap's with its own cut: one cluster with the
row in registers at 2 vectors a thread, else the cooperative grid."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.quant import _cluster_plan, _sm_count
from repro_torch.kernels.ref import set_row_ace_ref as plain  # noqa: F401
from repro_torch.kernels.row_delta import GRID_SCRATCH, PLACES

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None

STATE_DTYPES = (torch.float32, torch.bfloat16)
# vectors a thread the cluster kernel holds at most: it keeps u beside g and
# the old codes, and at 4 a thread a 1024-thread block's 64 registers a
# thread spill (csrc kernel instantiated for 2 only)
MAX_PER_THREAD = 2


def _ace_plan(d, sm_count):
    """Launch plan of the whole ACE step -> (cluster, threads, per_thread,
    on_chip): quantize_rows' registers plan for one row where it keeps at
    most `MAX_PER_THREAD` vectors a thread, else the cooperative grid
    (which sizes itself: the other three fields are then unused)."""
    plan = _cluster_plan(1, d, sm_count)
    if plan[3] == "registers" and plan[2] <= MAX_PER_THREAD:
        return plan
    return plan[:3] + ("grid",)


def cache_row_update(data, scale, j, g, u, inv_n, plan=None):
    """data (n, d) int8 and scale (n,) f32, updated in place; j a
    one-element int64 tensor; g (d,) f32; u (d,) f32 or bf16; inv_n a
    Python float, all tensors on one CUDA device -> u' (d,) in u's dtype.
    `plan` overrides `_ace_plan(d)`. Raises on anything else."""
    global launches, _entry
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("data: expected an (n, d) tensor")
    if not isinstance(j, torch.Tensor) or j.numel() != 1:
        raise ValueError("j: expected a one-element tensor")
    n, d = data.shape
    data = cuda_operand(data, "data", torch.int8, (n, d))
    dev = data.device
    scale = cuda_operand(scale, "scale", torch.float32, (n,), dev)
    j = cuda_operand(j.reshape(1), "j", torch.int64, (1,), dev)
    g = cuda_operand(g, "g", torch.float32, (d,), dev)
    state = getattr(u, "dtype", None)
    if state not in STATE_DTYPES:
        raise TypeError(f"u: dtype {state}, expected float32 or bfloat16")
    u = cuda_operand(u, "u", state, (d,), dev)
    u_new = torch.empty((d,), dtype=state, device=dev)
    cluster, threads, per_thread, on_chip = plan or _ace_plan(
        d, _sm_count(dev))
    partial = (torch.empty((GRID_SCRATCH,), dtype=torch.float32, device=dev)
               if on_chip == "grid" else None)
    if _entry is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _entry = build.function("cache_update", "cache_row_update",
                                [P] * 6 + [ctypes.c_float, P, I,
                                           ctypes.c_longlong] + [I] * 5
                                + [P])
    build.check("cache_update", _entry(
        g.data_ptr(), data.data_ptr(), scale.data_ptr(), j.data_ptr(),
        u.data_ptr(), u_new.data_ptr(), float(inv_n),
        None if partial is None else partial.data_ptr(), n, d, cluster,
        threads, per_thread, PLACES[on_chip], int(state == torch.bfloat16),
        stream_handle(dev)))
    launches += 1
    return u_new
