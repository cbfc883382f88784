"""Hand-written CUDA kernel: the whole int8 cache-row swap of the incremental
running-sum rules in one launch (port of `repro.kernels.row_delta` and of
the gather, scale and scatter that `FlatCache.set_row_delta` fuses around it
on the TPU).

    s = row_scale(g),  old = dq(data[j]),  delta = q(g)·s − old
    data[j] = q(g),  scale[j] = s                    (in place)

The kernel is ``csrc/row_delta.cu``; its plain version is
`ref.set_row_delta_ref` (``plain`` below), which `ops.row_delta` takes for
CPU tensors. The row index is a device tensor, read by the kernel, so a
call never waits for the card. The launch plan (`_row_plan`) is
quantize_rows' for one row, the same cluster split and exchange, where the
row fits a cluster's registers at 4 vectors a thread, else a cooperative
grid over the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.quant import _cluster_plan, _sm_count
from repro_torch.kernels.ref import set_row_delta_ref as plain  # noqa: F401

#: launches of the CUDA kernel in this process (see `ops.launch_counts`)
launches = 0
_entry = None

# on_chip of a plan: one cluster with the row in registers, or the
# cooperative grid over the card (csrc Place)
PLACES = {"registers": 0, "grid": 1}
GRID_SCRATCH = 8192         # the grid's per-block maxima (csrc kGridScratch)


def _row_plan(d, sm_count):
    """Launch plan of the row swap -> (cluster, threads, per_thread,
    on_chip): quantize_rows' registers plan for one row where it keeps at
    most 4 vectors a thread (the kernel holds the old codes beside them),
    else the cooperative grid (which sizes itself: the other three fields
    are then unused)."""
    plan = _cluster_plan(1, d, sm_count)
    if plan[3] == "registers" and plan[2] <= 4:
        return plan
    return plan[:3] + ("grid",)


def row_delta(data, scale, j, g, plan=None):
    """data (n, d) int8 and scale (n,) f32, updated in place; j a
    one-element int64 tensor; g (d,) f32, all on one CUDA device ->
    (delta (d,) f32, old (d,) f32). `plan` overrides `_row_plan(d)`.
    Raises on anything else."""
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
    delta = torch.empty((d,), dtype=torch.float32, device=dev)
    old = torch.empty((d,), dtype=torch.float32, device=dev)
    cluster, threads, per_thread, on_chip = plan or _row_plan(
        d, _sm_count(dev))
    partial = (torch.empty((GRID_SCRATCH,), dtype=torch.float32, device=dev)
               if on_chip == "grid" else None)
    if _entry is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _entry = build.function("row_delta", "row_delta",
                                [P] * 7 + [I, ctypes.c_longlong] + [I] * 4
                                + [P])
    build.check("row_delta", _entry(
        g.data_ptr(), data.data_ptr(), scale.data_ptr(), j.data_ptr(),
        delta.data_ptr(), old.data_ptr(),
        None if partial is None else partial.data_ptr(), n, d, cluster,
        threads, per_thread, PLACES[on_chip], stream_handle(dev)))
    launches += 1
    return delta, old
