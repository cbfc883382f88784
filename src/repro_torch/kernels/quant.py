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
row over a thread-block cluster and says where each block keeps its slice,
or, for a long row, over a cooperative grid that fills the card, each
row on a run of consecutive blocks (`_quant_slices` is the split either
kernel makes of a row); `_dequant_plan` cuts the flat codes into a
scalar head, aligned vectors of 4 codes and a scalar tail."""
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
ON_CHIP = {"registers": 0, "shared": 1, "stream": 2, "grid": 3}
# the cluster rule: the largest C (≤ 8) that leaves each block at least this
# many float4 vectors of its row
MIN_SLICE_VECTORS = 128
# a registers plan takes the fewest vectors a thread (2, 4, 8) whose grid
# holds at most this many threads per SM, half of what an SM keeps resident
GRID_THREADS_PER_SM = 1024
# the cooperative grid (csrc kGridThreads, kGridBlocksPerSm): blocks of this
# many threads, at most this many on an SM (the kernel's launch bounds),
# each thread keeping this many float4 loads in flight (4 or 8)
GRID_THREADS = 256
GRID_BLOCKS_PER_SM = 4
GRID_LOADS = 4
# a grid plan's blocks a row leave each thread at least this many vectors;
# a thread that walks this many or more keeps 8 loads in flight
GRID_VECTORS = 4
GRID_DEEP_VECTORS = 256
# the rule's grid takes rows of at least this many numbers
GRID_MIN_D = 1 << 17
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

    One cluster per row (`_cluster_plan`), or the cooperative grid
    (`_grid_plan`, on_chip "grid": `cluster` is then the blocks a row,
    `per_thread` the float4 loads a thread keeps in flight), which replaces
    the same two TPU calls (src/repro/kernels/quant.py:53 and :62) for long
    rows. The rule takes the grid for rows of `GRID_MIN_D` numbers or more
    while the n clusters of C would leave most SMs idle (n·C ≤ sm_count /
    2): where it was measured faster (tools/quant_designs.py --grid; NVIDIA
    H100 80GB HBM3, 700.00 W). At (1, 70,996) the two tie (0.00432 against
    0.00431 ms), at (1, 131,072) the grid takes 0.00429-0.00453 against the
    cluster's 0.00575; at (1, 262,144,000) 0.886-0.888 ms against 5.91
    (bound 0.391, two-pass floor 0.704), at (8, 45,088,768) 1.363 against
    1.963. By 16 rows of 45,088,768 the clusters fill the card and tie it,
    by 100 rows of 2^22 + 3 they win (1.295 against 1.64 ms). `cluster` and
    `on_chip` may be forced (tests, tuning): a forced cluster is a cluster
    plan, a forced "grid" takes `cluster` blocks a row if given; a forced
    place the slice does not fit raises."""
    if on_chip == "grid":
        return _grid_plan(n, d, sm_count, cluster)
    plan = _cluster_plan(n, d, sm_count, cluster, on_chip)
    if (cluster is None and on_chip is None and d >= GRID_MIN_D
            and 2 * n * plan[0] <= sm_count):
        return _grid_plan(n, d, sm_count)
    return plan


@functools.lru_cache(maxsize=256)
def _cluster_plan(n, d, sm_count, cluster=None, on_chip=None):
    """The plan that spreads each row over one thread-block cluster ->
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


def _grid_plan(n, d, sm_count, per_row=None):
    """The cooperative grid's plan -> (per_row, GRID_THREADS, loads,
    "grid"): `per_row` blocks a row, by default as many as the card holds
    at `GRID_BLOCKS_PER_SM` or fewer, so that each thread walks at least
    `GRID_VECTORS` vectors; n·per_row blocks in all, every one of them
    co-resident. Each thread keeps `GRID_LOADS` float4 loads in flight, 8
    where it walks `GRID_DEEP_VECTORS` or more. A grid that does not fit
    the card raises."""
    capacity = GRID_BLOCKS_PER_SM * sm_count
    nv = d // 4
    if per_row is None:
        per_row = max(1, min(capacity // n, -(-nv // (
            GRID_THREADS * GRID_VECTORS))))
    if per_row < 1 or n * per_row > capacity:
        raise ValueError(f"quantize_rows: no grid of {per_row} blocks a row "
                         f"for n={n} on {sm_count} SMs")
    deep = nv >= per_row * GRID_THREADS * GRID_DEEP_VECTORS
    return per_row, GRID_THREADS, 8 if deep else GRID_LOADS, "grid"


def _quant_slices(d, head, cluster):
    """The kernels' split of one row whose x starts `head` elements before a
    16-byte boundary (head = min(head, d)) over C = `cluster` blocks (a
    cluster's, or a grid's `per_row`): block 0 the scalar head, each block
    c the float4 vectors [c·nv/C, (c+1)·nv/C), block C-1 the scalar tail ->
    per block, its list of [lo, hi) element ranges."""
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
    # the grid's per-block maxima (in a captured graph, from its pool)
    partial = (torch.empty((n * cluster,), dtype=torch.float32,
                           device=x.device) if on_chip == "grid" else None)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _entry("quantize_rows", [P, P, P, I, ctypes.c_longlong] + [I] * 4
                + [P, P])
    build.check("quant", fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d,
                            cluster, threads, per_thread, ON_CHIP[on_chip],
                            None if partial is None else partial.data_ptr(),
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
