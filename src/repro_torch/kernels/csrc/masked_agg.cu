// ACED's bounded-delay aggregation over the whole int8 cache (the literal
// `aced_direct` rule, paper Alg. a.1 line 7):
//     w_i  = m_i · s_i / max(Σ_i m_i, 1)
//     u[j] = Σ_{i=0..n-1} w_i · C[i, j]           (f32)
//
// Replaces the TPU kernel src/repro/kernels/masked_agg.py::masked_agg
// (pallas_call at masked_agg.py:46), called from ACEDDirect.step on every
// int8 tick.
//
// Bound on an H100: memory. It reads the (n, d) int8 cache once (1 B per
// element) and writes u (4 B per feature); the 2 flops per element are far
// below the f32 rate. At the vision task's n = 100, d = 17,226 that is
// 1.79 MB, about 0.53 µs at 3.35 TB/s — below the launch latency, so on the
// engine's path the kernel is launch-bound.
// Design: each thread owns one feature column and walks the n rows in order
// 0..n-1, accumulating w_i·C[i, j] in an f32 register: no atomics, no
// cross-block pass, deterministic, and the plain version
// (ref.masked_agg_ref) sums in the same order, so the two agree bit for bit
// (-fmad=false keeps the product rounded before the add). A warp reads 32
// consecutive bytes of a row. The weights are formed on the device by every
// block, from the (n,) mask and scales, in chunks of kChunk rows staged in
// shared memory: the TPU wrapper forms them outside the Pallas body
// (masked_agg.py:40-41); here that would cost extra launches per tick.
#include "common.cuh"

namespace {

constexpr int kChunk = 2048;

__global__ void masked_agg_kernel(const int8_t* __restrict__ cache,
                                  const float* __restrict__ scales,
                                  const bool* __restrict__ mask,
                                  float* __restrict__ out, int n,
                                  long long d) {
  __shared__ float w[kChunk];
  __shared__ int warp_counts[repro::kThreads / 32];
  __shared__ float denom;

  // Σ m: integer count, exact (and order-free) like the f32 sum of 0/1
  int count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) count += mask[i] ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k)
      total += warp_counts[k];
    denom = fmaxf(static_cast<float>(total), 1.f);
  }
  __syncthreads();

  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int rows = min(kChunk, n - c0);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const float m = mask[c0 + i] ? 1.f : 0.f;
      w[i] = m * scales[c0 + i] / denom;
    }
    __syncthreads();
    if (j < d) {
      const int8_t* col = cache + static_cast<long long>(c0) * d + j;
      for (int i = 0; i < rows; ++i)
        acc = acc + w[i] * static_cast<float>(col[static_cast<long long>(i) * d]);
    }
    __syncthreads();
  }
  if (j < d) out[j] = acc;
}

}  // namespace

REPRO_EXPORT int masked_agg(const void* cache, const void* scales,
                            const void* mask, void* out, int n, long long d,
                            void* stream) {
  if (d > 0) {
    masked_agg_kernel<<<repro::blocks_for(d), repro::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(cache), static_cast<const float*>(scales),
        static_cast<const bool*>(mask), static_cast<float*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
