"""Hand-written CUDA kernels: symmetric per-row int8 quantization and its
inverse (port of `repro.kernels.quant`, paper App. F.3.3).

    s = max(max|x_row|, 1e-12) / 127,  q = clip(rint(x / s), ±127)   (int8)
    x = q·s                                                          (f32)

Both kernels are in ``csrc/quant.cu``; their plain versions are
`ref.quantize_rows_ref` and `ref.dequantize_rows_ref`, which
`ops.quantize_rows` / `ops.dequantize_rows` take for CPU tensors. The two
count their launches apart (`quantize_launches`, `dequantize_launches`).

Each launch follows a plan computed here, in plain Python, and passed to
the kernel, which refuses a plan that does not fit: `_quant_plan` splits a
row over a thread-block cluster and says where each block keeps its slice
(`_quant_slices` is the split the kernel makes), `_dequant_plan` cuts the
flat codes into a scalar head, aligned vectors of 4 codes and a scalar
tail."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import cuda_operand, stream_handle
from repro_torch.kernels.ref import dequantize_rows_ref  # noqa: F401
from repro_torch.kernels.ref import quantize_rows_ref  # noqa: F401

#: launches of each CUDA kernel in this process (see `ops.launch_counts`)
quantize_launches = 0
dequantize_launches = 0
_entries = {}
_sm_counts = {}

# limits the kernels check too (csrc/quant.cu)
MAX_THREADS = 1024
SMEM_BYTES = 227 * 1024 - 1024       # a kShared block's dynamic shared memory
ON_CHIP = {"registers": 0, "shared": 1, "stream": 2}
# the cluster rule: the largest C (≤ 8) that leaves each block at least this
# many float4 vectors of its row
MIN_SLICE_VECTORS = 128
# a registers plan takes the fewest vectors a thread (2, 4, 8) whose grid
# holds at most this many threads per SM, half of what an SM keeps resident
GRID_THREADS_PER_SM = 1024
# dequantize_rows' block size
DEQUANT_THREADS = 256


def _entry(symbol, argtypes):
    fn = _entries.get(symbol)
    if fn is None:
        fn = build.function("quant", symbol, argtypes)
        _entries[symbol] = fn
    return fn


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per process and device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


@functools.lru_cache(maxsize=256)
def _quant_plan(n, d, sm_count, cluster=None, on_chip=None):
    """Launch plan of quantize_rows for (n, d) on `sm_count` SMs ->
    (cluster, threads, per_thread, on_chip).

    `cluster` blocks (a power of two ≤ 8) share each row: the most that
    leave each block `MIN_SLICE_VECTORS` vectors. A block's slice lives in
    registers (`per_thread` float4 vectors a thread: the fewest of 2, 4, 8
    that fit the slice in one block and keep the grid within
    `GRID_THREADS_PER_SM`, `threads` just enough), else in shared memory,
    else it is streamed (read twice); those two load 4 vectors a thread
    per step. `cluster` and `on_chip` may be forced (tests, tuning); a
    forced place the slice does not fit raises."""
    if cluster is None:
        cluster = 1
        while (cluster < 8 and d // 4 // (2 * cluster) >= MIN_SLICE_VECTORS
               and n * 2 * cluster < 1 << 31):
            cluster *= 2
    if cluster not in (1, 2, 4, 8) or n * cluster >= 1 << 31:
        raise ValueError(f"quantize_rows: no cluster of {cluster} for "
                         f"n={n}")
    slice_vectors = -(-(d // 4) // cluster)
    fits = {"registers": slice_vectors <= 8 * MAX_THREADS,
            "shared": 16 * slice_vectors <= SMEM_BYTES, "stream": True}
    if on_chip is None:
        on_chip = next(k for k in ("registers", "shared", "stream")
                       if fits[k])
    if not fits[on_chip]:
        raise ValueError(f"quantize_rows: a slice of {slice_vectors} "
                         f"vectors does not fit in {on_chip}")
    if on_chip != "registers":
        return cluster, MAX_THREADS, 4, on_chip

    def threads(per_thread):            # whole warps, at least one
        return max(32, (-(-slice_vectors // per_thread) + 31) // 32 * 32)

    per_thread = next((v for v in (2, 4) if threads(v) <= MAX_THREADS and
                       n * cluster * threads(v)
                       <= GRID_THREADS_PER_SM * sm_count), 8)
    return cluster, threads(per_thread), per_thread, on_chip


def _quant_slices(d, head, cluster):
    """The kernel's split of one row whose x starts `head` elements before a
    16-byte boundary (head = min(head, d)): block 0 the scalar head, each
    block c the float4 vectors [c·nv/C, (c+1)·nv/C), block C-1 the scalar
    tail -> per block, its list of [lo, hi) element ranges."""
    head = min(head, d)
    nv = (d - head) // 4
    out = []
    for c in range(cluster):
        lo, hi = c * nv // cluster, (c + 1) * nv // cluster
        ranges = [(head + 4 * lo, head + 4 * hi)]
        if c == 0:
            ranges.insert(0, (0, head))
        if c == cluster - 1:
            ranges.append((head + 4 * nv, d))
        out.append([r for r in ranges if r[1] > r[0]])
    return out


def _dequant_plan(n, d, q_addr, x_addr):
    """Launch plan of dequantize_rows over the n·d flat codes at byte
    address `q_addr` into f32 at `x_addr` -> (head, width, vec_q, threads,
    blocks): `head` scalar codes align the output to 16 bytes (and q to 4
    with it where they agree, `vec_q`), then vectors of `width` = 4
    consecutive codes (1, all scalar, where d < 4), one a thread, then a
    scalar tail."""
    width = 4 if d >= 4 else 1
    head = (-x_addr // 4) % 4 if width > 1 else 0   # to x's 16-byte line
    vec_q = width > 1 and (q_addr + head) % 4 == 0
    vectors = (n * d - head) // width
    blocks = max(1, -(-vectors // DEQUANT_THREADS))
    return head, width, vec_q, DEQUANT_THREADS, blocks


def _rows(x, name, dtype):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name}: expected an (n, d) tensor")
    return cuda_operand(x, name, dtype, tuple(x.shape))


def quantize_rows(x, plan=None):
    """x (n, d) f32 on a CUDA device -> (q (n, d) int8, scales (n,) f32).
    `plan` overrides `_quant_plan`'s. Raises on anything else."""
    global quantize_launches
    x = _rows(x, "x", torch.float32)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    s = torch.empty((n,), dtype=torch.float32, device=x.device)
    cluster, threads, per_thread, on_chip = plan or _quant_plan(
        n, d, _sm_count(x.device))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _entry("quantize_rows", [P, P, P, I, ctypes.c_longlong] + [I] * 4
                + [P])
    build.check("quant", fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d,
                            cluster, threads, per_thread, ON_CHIP[on_chip],
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
    head, width, vec_q, threads, blocks = _dequant_plan(
        n, d, q.data_ptr(), x.data_ptr())
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _entry("dequantize_rows", [P, P, P, I, L, L, I, I, I, L, P])
    build.check("quant", fn(q.data_ptr(), s.data_ptr(), x.data_ptr(), n, d,
                            head, width, int(vec_q), threads, blocks,
                            stream_handle(q.device)))
    dequantize_launches += 1
    return x
