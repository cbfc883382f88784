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
// 0.026 µs, far below the launch latency: one block on one SM is all the
// work there is, so that call is launch-bound.
//
// quantize_rows: one block per row and one launch for both TPU phases.
// Pass 1 is a block |max| reduction (warp shuffles, then shared memory);
// max is order-free, so the scale is bit-exact whatever the order. NaN
// propagates through the max, as through torch.amax. Thread 0 writes the
// scale; pass 2 re-reads the row (L2-resident at the engine's d) and writes
// the codes with repro::quant, the rounding contract every int8 writer of
// the port shares (IEEE division, round half to even, clip).
// dequantize_rows: a 2-D grid, features on x and rows on y (strided when
// n > 65,535), so no thread divides to find its row.
#include "common.cuh"

namespace {

constexpr int kQuantThreads = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales, long long d) {
  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ float row_scale;
  const long long base = static_cast<long long>(blockIdx.x) * d;

  float m = 0.f;
  for (long long j = threadIdx.x; j < d; j += blockDim.x)
    m = nan_max(fabsf(x[base + j]), m);
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(__shfl_down_sync(0xffffffffu, m, off), m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = warp_max[0];
    for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k)
      r = nan_max(warp_max[k], r);
    // clamp before dividing, as kernels/ref.row_scale does (NaN stays NaN)
    const float s = (r < 1e-12f ? 1e-12f : r) / 127.f;
    row_scale = s;
    scales[blockIdx.x] = s;
  }
  __syncthreads();

  const float s = row_scale;
  for (long long j = threadIdx.x; j < d; j += blockDim.x)
    q[base + j] = static_cast<int8_t>(repro::quant(x[base + j], s));
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x, int n,
                                       long long d) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    const long long i = static_cast<long long>(r) * d + j;
    x[i] = static_cast<float>(q[i]) * scales[r];
  }
}

}  // namespace

REPRO_EXPORT int quantize_rows(const void* x, void* q, void* scales, int n,
                               long long d, void* stream) {
  if (n > 0 && d > 0) {
    quantize_rows_kernel<<<n, kQuantThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), d);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int dequantize_rows(const void* q, const void* scales, void* x,
                                 int n, long long d, void* stream) {
  if (n > 0 && d > 0) {
    const dim3 grid(repro::blocks_for(d),
                    static_cast<unsigned>(n < 65535 ? n : 65535));
    dequantize_rows_kernel<<<grid, repro::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(x), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
