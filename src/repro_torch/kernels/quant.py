"""Hand-written CUDA kernels: symmetric per-row int8 quantization and its
inverse (port of `repro.kernels.quant`, paper App. F.3.3).

    s = max(max|x_row|, 1e-12) / 127,  q = clip(rint(x / s), ±127)   (int8)
    x = q·s                                                          (f32)

Both kernels are in ``csrc/quant.cu``; their plain versions are
`ref.quantize_rows_ref` and `ref.dequantize_rows_ref`, which
`ops.quantize_rows` / `ops.dequantize_rows` take for CPU tensors. The two
count their launches apart (`quantize_launches`, `dequantize_launches`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.ref import dequantize_rows_ref  # noqa: F401
from repro_torch.kernels.ref import quantize_rows_ref  # noqa: F401

#: launches of each CUDA kernel in this process (see `ops.launch_counts`)
quantize_launches = 0
dequantize_launches = 0
_entries = {}


def _entry(symbol):
    fn = _entries.get(symbol)
    if fn is None:
        P = ctypes.c_void_p
        fn = build.function("quant", symbol, [P] * 3 + [ctypes.c_int,
                                                       ctypes.c_longlong, P])
        _entries[symbol] = fn
    return fn


def _rows(x, name, dtype):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name}: expected an (n, d) tensor")
    return cuda_operand(x, name, dtype, tuple(x.shape))


def quantize_rows(x):
    """x (n, d) f32 on a CUDA device -> (q (n, d) int8, scales (n,) f32).
    Raises on anything else."""
    global quantize_launches
    x = _rows(x, "x", torch.float32)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    s = torch.empty((n,), dtype=torch.float32, device=x.device)
    build.check("quant", _entry("quantize_rows")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d,
        stream_handle(x.device)))
    quantize_launches += 1
    return q, s


def dequantize_rows(q, s):
    """q (n, d) int8; s (n,) f32, on one CUDA device -> x (n, d) f32.
    Raises on anything else."""
    global dequantize_launches
    q = _rows(q, "q", torch.int8)
    n, d = q.shape
    s = cuda_operand(s, "s", torch.float32, (n,), q.device)
    x = torch.empty((n, d), dtype=torch.float32, device=q.device)
    build.check("quant", _entry("dequantize_rows")(
        q.data_ptr(), s.data_ptr(), x.data_ptr(), n, d,
        stream_handle(q.device)))
    dequantize_launches += 1
    return x
