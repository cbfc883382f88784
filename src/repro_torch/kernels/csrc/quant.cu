// Symmetric per-row int8 quantization of an (n, d) f32 matrix, and its
// inverse (paper App. F.3.3):
//     s_r     = max(max_j |x[r, j]|, 1e-12) / 127
//     q[r, j] = clip(rint(x[r, j] / s_r), -127, 127)          (int8)
//     x[r, j] = q[r, j] · s_r                                 (dequantize)
//
// Replaces the TPU kernels of src/repro/kernels/quant.py: quantize_rows
// (the |max| pallas_call at quant.py:53 and the quantize pallas_call at
// quant.py:62) and dequantize_rows (pallas_call at quant.py:83). On the
// port's path FlatCache.set_row quantizes one arriving row per tick, the
// int8 cache init quantizes (n, d) once, and cache_mean / FlatCache.rows /
// cache_sum dequantize.
//
// Bound on an H100: memory. quantize_rows must read x once (4 B) and write
// q (1 B) per element, plus 4 B of scale per row; dequantize_rows reads
// 1 B and writes 4 B per element. At (100, 17,226) each moves 8.6 MB,
// about 2.6 µs at 3.35 TB/s; at (1, 17,226) the quantizer's 86 KB take
// 0.026 µs, far below the launch latency, so that call is latency-bound:
// what counts there is how many SMs share the row and how few dependent
// steps each takes.
//
// quantize_rows: one launch for both TPU phases. A row is split over a
// thread-block cluster of C blocks, and the blocks agree on its |max|, as
// cluster_row.cuh describes (the host plan, kernels/quant.py `_quant_plan`,
// picks C, the block size and where the slice lives). A block loads its
// whole slice once, every load issued before the first use, and keeps it on
// chip: in registers, else in shared memory; only a slice that fits
// neither is read twice (`kStream`, its second pass walking backwards, so
// the most recently read part may still be in L2). Block 0 writes the
// scale. The codes go out through repro::quant, the rounding contract every
// int8 writer of the port shares (IEEE division, round half to even, clip,
// NaN to 0), as char4 where q is aligned.
//
// Long rows take a cooperative grid over the whole card instead
// (`quantize_rows_grid_kernel`, the plan's "grid"): a cluster of 8 keeps
// at most 462,848 numbers of a row on chip, and a longer row streamed on 8
// of the 132 SMs ran at ~0.4 TB/s (5.91 ms at (1, 262,144,000)).
// Nothing produces the row's max beforehand and a 1 GB row does not fit on
// chip, so the grid reads x twice too: its floor is 9 B a number (0.704 ms
// at (1, 262,144,000), 0.176 ms at (1, 65,536,000), at 3.35 TB/s), beside
// the 5 B a number of the single-read bound (0.391, 0.098 ms). It replaces
// the same two TPU calls. Measured (tools/quant_designs.py --grid; NVIDIA
// H100 80GB HBM3, 700.00 W): 0.886-0.888 ms at (1, 262,144,000) against
// the cluster's 5.91, 0.203 ms at (1, 65,536,000) against 1.486, 1.363 ms
// at (8, 45,088,768) against 1.963. The crossover: at (1, 70,996) the grid
// (35 blocks, 0.00432 ms) ties the cluster (0.00431), at (1, 131,072) it
// takes 0.00429-0.00453 against 0.00575, so the host plan sends it rows
// from 131,072 numbers; by 16 rows of 45,088,768 the clusters fill 128 SMs
// and tie it (2.89-2.92 against 2.87-2.98 ms), by 100 rows of 2^22 + 3 they
// win (1.295 against 1.64 ms). A short row wants fewer blocks (a grid-wide
// sync costs more than it saves): the plan leaves each thread at least 4
// vectors, and a thread that walks 256 or more keeps 8 loads in flight
// (0.887 against 0.916 ms at (1, 262,144,000)).
//
// dequantize_rows: the (n, d) codes as one flat array, in vectors of 4
// consecutive codes, one a thread (one char4 load, one float4 store: a
// warp's access is 128 B of q and 512 B of x, contiguous), on as many
// blocks as that takes. A thread finds its vector's row with one division
// (32-bit while n·d < 2^31), and since d ≥ 4 a vector crosses at most one
// row boundary: each code takes s[r] or s[r + 1]. A scalar head aligns the
// output to 16 bytes, a scalar tail ends it. Where q's alignment disagrees
// with x's, the codes are loaded a byte at a time and still stored as
// float4; where d < 4 every element is scalar. The host plan
// (`_dequant_plan`) computes the split. A grid-stride grid of 8 blocks per
// SM took 0.77-0.78 ms at (100, 2^22 + 3) against 0.71 for one vector a
// thread (tools/quant_designs.py; NVIDIA H100 80GB HBM3, 700.00 W);
// sixteen consecutive codes a thread would spread a warp's float4 stores
// over 2 KB at a 64-byte stride.
#include "cluster_row.cuh"

namespace {

using repro::abs_max4;
using repro::kMaxThreads;
using repro::kRegisters;
using repro::kShared;
using repro::kSmemBytes;
using repro::kStream;
using repro::kUnroll;
using repro::nan_max;

// The codes of vector i of the row's aligned run, as one char4 where q is
// 4-byte aligned there (`q4`), else byte by byte.
__device__ __forceinline__ void put_codes(int8_t* qv, long long i, float4 v,
                                          float s, bool q4) {
  const int8_t a = static_cast<int8_t>(repro::quant(v.x, s));
  const int8_t b = static_cast<int8_t>(repro::quant(v.y, s));
  const int8_t c = static_cast<int8_t>(repro::quant(v.z, s));
  const int8_t e = static_cast<int8_t>(repro::quant(v.w, s));
  if (q4) {
    reinterpret_cast<char4*>(qv)[i] = make_char4(a, b, c, e);
  } else {
    int8_t* p = qv + 4 * i;
    p[0] = a;
    p[1] = b;
    p[2] = c;
    p[3] = e;
  }
}

// Grid: n·C blocks, clusters of C along x; block b serves row b / C as
// cluster rank b % C. kRegisters holds V vectors a thread; kShared and
// kStream walk the slice kUnroll vectors a thread at a time.
template <int kMode, int V>
__global__ void __launch_bounds__(kMaxThreads)
    quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long d) {
  extern __shared__ float4 slice[];
  __shared__ repro::ClusterMax exchange;
  repro::cg::cluster_group cluster = repro::cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());  // a power of two
  const int log2c = __ffs(C) - 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x >> log2c;
  const int tid = threadIdx.x, T = blockDim.x;

  const float* xr = x + row * d;
  int8_t* qr = q + row * d;
  const repro::RowSplit sp(xr, d, rank, log2c, tid);
  const long long vlo = sp.vlo, vhi = sp.vhi, ej = sp.ej;
  const float4* xv = reinterpret_cast<const float4*>(xr + sp.h);
  int8_t* qv = qr + sp.h;
  const bool q4 = (reinterpret_cast<uintptr_t>(qv) & 3) == 0;
  const float e = ej >= 0 ? xr[ej] : 0.f;
  exchange.start(C);

  // pass 1: load the slice once and take its |max|
  float m = 0.f;
  float4 reg[kMode == kRegisters ? V : 1];
  if constexpr (kMode == kRegisters) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long i = vlo + tid + static_cast<long long>(k) * T;
      reg[k] = i < vhi ? xv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) m = abs_max4(reg[k], m);
  } else {
    for (long long base = vlo + tid; base < vhi;
         base += static_cast<long long>(kUnroll) * T) {
      float4 a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * T;
        a[u] = i < vhi ? xv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * T;
        if (kMode == kShared && i < vhi) slice[i - vlo] = a[u];
        m = abs_max4(a[u], m);
      }
    }
  }

  const float s = repro::row_scale(
      exchange.combine(nan_max(fabsf(e), m), C, rank));
  if (rank == 0 && tid == 0) scales[row] = s;

  // pass 2: the codes, from where pass 1 left the slice
  if (ej >= 0) qr[ej] = static_cast<int8_t>(repro::quant(e, s));
  if constexpr (kMode == kRegisters) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long i = vlo + tid + static_cast<long long>(k) * T;
      if (i < vhi) put_codes(qv, i, reg[k], s, q4);
    }
  } else {
    const long long step = static_cast<long long>(kUnroll) * T;
    const long long steps = (vhi - vlo + step - 1) / step;
    for (long long it = steps - 1; it >= 0; --it) {
      const long long base = vlo + tid + it * step;
      float4 a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * T;
        if (i < vhi) a[u] = kMode == kShared ? slice[i - vlo] : xv[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * T;
        if (i < vhi) put_codes(qv, i, a[u], s, q4);
      }
    }
  }
}

// The cooperative grid, for rows that one cluster could only stream: n·B
// blocks, the B blocks of row b / B in a run, block b serving it as rank
// b % B (`repro::split_row`). Pass 1 takes the block's |max| into
// partial[b], U float4 loads a thread in flight; grid.sync(); each block
// combines its row's B maxima (order-free, so every block derives the same
// scale bits) and pass 2 walks its slice backwards, so that what pass 1
// read last is still in L2.
constexpr int kGrid = 3;                // on_chip of a grid plan
constexpr int kGridThreads = 256;
constexpr int kGridBlocksPerSm = 4;     // the blocks a plan may put on an SM

template <int U>
__global__ void __launch_bounds__(kGridThreads, kGridBlocksPerSm)
    quantize_rows_grid_kernel(const float* __restrict__ x,
                              int8_t* __restrict__ q,
                              float* __restrict__ scales, float* partial,
                              long long d, int per_row) {
  __shared__ float warp_part[kGridThreads / 32];
  __shared__ float row_max;
  repro::cg::grid_group grid = repro::cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / per_row;
  const long long rank = blockIdx.x - row * per_row;
  const float* xr = x + row * d;
  int8_t* qr = q + row * d;
  const repro::RowSplit sp = repro::split_row(xr, d, rank, per_row, tid);
  const long long vlo = sp.vlo, vhi = sp.vhi, ej = sp.ej;
  const float4* xv = reinterpret_cast<const float4*>(xr + sp.h);
  int8_t* qv = qr + sp.h;
  const bool q4 = (reinterpret_cast<uintptr_t>(qv) & 3) == 0;
  const float e = ej >= 0 ? xr[ej] : 0.f;
  const long long step = static_cast<long long>(U) * kGridThreads;

  float m = nan_max(fabsf(e), 0.f);
  for (long long base = vlo + tid; base < vhi; base += step) {
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kGridThreads;
      a[u] = i < vhi ? xv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) m = abs_max4(a[u], m);
  }
  m = repro::warp_max(m);
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = repro::warp_max(lane < kGridThreads / 32 ? warp_part[lane] : 0.f);
    if (lane == 0) partial[blockIdx.x] = m;
  }
  grid.sync();
  if (warp == 0) {
    const float* pr = partial + row * per_row;
    float r = 0.f;
    for (int k = lane; k < per_row; k += 32) r = nan_max(__ldcg(pr + k), r);
    r = repro::warp_max(r);
    if (lane == 0) row_max = r;
  }
  __syncthreads();
  const float s = repro::row_scale(row_max);
  if (rank == 0 && tid == 0) scales[row] = s;

  if (ej >= 0) qr[ej] = static_cast<int8_t>(repro::quant(e, s));
  for (long long it = (vhi - vlo + step - 1) / step - 1; it >= 0; --it) {
    const long long base = vlo + tid + it * step;
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kGridThreads;
      if (i < vhi) a[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kGridThreads;
      if (i < vhi) put_codes(qv, i, a[u], s, q4);
    }
  }
}

// Thread v: the codes of vector v, W = 4 codes from i = head + 4v; row
// r = i / d, and since d ≥ 4 the codes from (r + 1)·d on belong to row
// r + 1. kVecQ loads the four codes as one char4 (q + i aligned to 4),
// else byte by byte; x + i is 16-byte aligned. The first threads also take
// the scalar head and tail. W = 1 is the scalar path (d < 4).
template <int W, bool kVecQ, typename I>
__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x, I d, I N, I head,
                                       I nvec) {
  const I v = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  const I tail0 = head + nvec * W;
  if (v < head) x[v] = static_cast<float>(q[v]) * scales[v / d];
  if (v < N - tail0) x[tail0 + v] =
      static_cast<float>(q[tail0 + v]) * scales[(tail0 + v) / d];
  if (v >= nvec) return;
  const I i = head + v * W;
  if constexpr (W == 1) {
    x[i] = static_cast<float>(q[i]) * scales[i / d];
  } else {
    const char4 c = kVecQ ? *reinterpret_cast<const char4*>(q + i)
                          : make_char4(q[i], q[i + 1], q[i + 2], q[i + 3]);
    const I r = i / d;
    const I next = (r + 1) * d;        // first code of row r + 1
    const float s0 = scales[r];
    const float s1 = next < i + W ? scales[r + 1] : s0;
    *reinterpret_cast<float4*>(x + i) = make_float4(
        static_cast<float>(c.x) * s0,
        static_cast<float>(c.y) * (i + 1 < next ? s0 : s1),
        static_cast<float>(c.z) * (i + 2 < next ? s0 : s1),
        static_cast<float>(c.w) * (i + 3 < next ? s0 : s1));
  }
}

template <int kMode, int V>
cudaError_t launch_quant(const float* x, int8_t* q, float* scales, int n,
                         long long d, int cluster, int threads, size_t smem,
                         cudaStream_t stream) {
  auto kernel = quantize_rows_kernel<kMode, V>;
  if (kMode == kShared) {
    static const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (set != cudaSuccess) return set;
  }
  return repro::launch_cluster(kernel, static_cast<unsigned>(n) * cluster,
                               cluster, threads, smem, stream, x, q, scales,
                               d);
}

// One cooperative launch of n·per_row blocks; refused unless all of them
// are co-resident (the occupancy the launch bounds promise, times the SMs).
template <int U>
cudaError_t launch_grid(const float* x, int8_t* q, float* scales,
                        float* partial, int n, long long d, int per_row,
                        cudaStream_t stream) {
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantize_rows_grid_kernel<U>, kGridThreads, 0);
    if (err != cudaSuccess) {
      per_sm = -1;
      return err;
    }
  }
  const long long blocks = static_cast<long long>(n) * per_row;
  if (blocks > static_cast<long long>(per_sm) * sms)
    return cudaErrorInvalidValue;
  void* args[] = {&x, &q, &scales, &partial, &d, &per_row};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(quantize_rows_grid_kernel<U>),
      dim3(static_cast<unsigned>(blocks)), dim3(kGridThreads), args, 0,
      stream);
}

template <int W, bool kVecQ, typename I>
cudaError_t launch_dequant(const int8_t* q, const float* s, float* x,
                           long long d, long long N, long long head,
                           int threads, long long blocks, cudaStream_t st) {
  dequantize_rows_kernel<W, kVecQ, I>
      <<<static_cast<unsigned>(blocks), threads, 0, st>>>(
          q, s, x, static_cast<I>(d), static_cast<I>(N), static_cast<I>(head),
          static_cast<I>((N - head) / W));
  return cudaGetLastError();
}

template <typename I>
cudaError_t dequant_plan(const int8_t* q, const float* s, float* x,
                         long long d, long long N, long long head, int width,
                         bool vec_q, int threads, long long blocks,
                         cudaStream_t st) {
  if (width == 1)
    return launch_dequant<1, false, I>(q, s, x, d, N, head, threads, blocks,
                                       st);
  return vec_q ? launch_dequant<4, true, I>(q, s, x, d, N, head, threads,
                                            blocks, st)
               : launch_dequant<4, false, I>(q, s, x, d, N, head, threads,
                                             blocks, st);
}

}  // namespace

// plan: `cluster` blocks per row (1, 2, 4 or 8) of `threads` threads;
// `on_chip` 0 = registers (`per_thread` 2, 4 or 8 vectors a thread), 1 =
// shared memory, 2 = stream; 3 = the cooperative grid, `cluster` blocks
// per row (any count ≥ 1) of kGridThreads threads, `per_thread` = 4 or 8
// loads in flight, the blocks' maxima in `partial` (n·cluster floats). A
// plan whose slices do not fit where it says is refused
// (cudaErrorInvalidValue), never run.
REPRO_EXPORT int quantize_rows(const void* x, void* q, void* scales, int n,
                               long long d, int cluster, int threads,
                               int per_thread, int on_chip, void* partial,
                               void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* xf = static_cast<const float*>(x);
  auto* qi = static_cast<int8_t*>(q);
  auto* sf = static_cast<float*>(scales);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (on_chip == kGrid) {
    auto* pf = static_cast<float*>(partial);
    if (pf == nullptr || cluster < 1 || threads != kGridThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    if (per_thread == 4)
      err = launch_grid<4>(xf, qi, sf, pf, n, d, cluster, st);
    else if (per_thread == 8)
      err = launch_grid<8>(xf, qi, sf, pf, n, d, cluster, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const long long slice = ((d >> 2) + cluster - 1) / cluster;  // vectors
  if (!repro::row_plan_fits(d, cluster, threads, per_thread, on_chip) ||
      static_cast<long long>(n) * cluster >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (on_chip == kRegisters && per_thread == 2)
    err = launch_quant<kRegisters, 2>(xf, qi, sf, n, d, cluster, threads, 0,
                                      st);
  else if (on_chip == kRegisters && per_thread == 4)
    err = launch_quant<kRegisters, 4>(xf, qi, sf, n, d, cluster, threads, 0,
                                      st);
  else if (on_chip == kRegisters)
    err = launch_quant<kRegisters, 8>(xf, qi, sf, n, d, cluster, threads, 0,
                                      st);
  else if (on_chip == kShared)
    err = launch_quant<kShared, 1>(xf, qi, sf, n, d, cluster, threads,
                                   static_cast<size_t>(slice) * 16, st);
  else
    err = launch_quant<kStream, 1>(xf, qi, sf, n, d, cluster, threads, 0,
                                   st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// plan: `head` scalar codes, then vectors of `width` codes (4; 1 is the
// scalar path), one a thread, loaded as one char4 when `vec_q`, on
// `blocks` blocks of `threads`. A plan that would misalign a vector or
// leave one out is refused.
REPRO_EXPORT int dequantize_rows(const void* q, const void* scales, void* x,
                                 int n, long long d, long long head,
                                 int width, int vec_q, int threads,
                                 long long blocks, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const long long N = static_cast<long long>(n) * d;
  const auto qa = reinterpret_cast<uintptr_t>(q) + head;
  const auto xa = reinterpret_cast<uintptr_t>(x) + 4 * head;
  const bool ok =
      (width == 1 || (width == 4 && d >= 4 && xa % 16 == 0 &&
                      (!vec_q || qa % 4 == 0))) &&
      head >= 0 && head < 4 && (width == 4 || head == 0) && threads >= 32 &&
      threads <= kMaxThreads && blocks >= 1 && blocks < (1LL << 31) &&
      blocks * threads >= (N - head) / width;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(scales);
  auto* xf = static_cast<float*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      N < (1LL << 31)
          ? dequant_plan<unsigned>(qi, sf, xf, d, N, head, width, vec_q != 0,
                                   threads, blocks, st)
          : dequant_plan<unsigned long long>(qi, sf, xf, d, N, head, width,
                                             vec_q != 0, threads, blocks, st);
  return static_cast<int>(err);
}
