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
// 1.79 MB, about 0.53 µs at 3.35 TB/s, so at that shape the kernel is
// latency-bound: what counts is how many loads are in flight on how many
// SMs before the first add.
//
// Design: each block owns a column tile of kF = 128 features across all n
// rows (⌈d / 128⌉ blocks: 135 at d = 17,226, one an SM), staged into shared
// memory with cp.async in chunks of up to 128 rows (the host plan,
// kernels/masked_agg.py `_agg_plan`), every copy of a chunk issued at once.
// A row's tile starts at byte 10·i mod 16 at d = 17,226 (odd rows only
// 2-byte aligned), so the copies take the aligned 16-byte words that cover
// the tile, kF/16 + 1 of them, and the row's byte offset into its first word
// is kept: a word that reaches outside the cache (its first or last bytes)
// is read byte by byte. TMA cannot take the cache: a 2-D tensor map needs a
// row stride that is a multiple of 16 bytes. Thread r loads row r's mask bit
// and scale before it issues its copies; while the copies land the block
// counts the mask (__syncthreads_count, one barrier per 128 rows) and thread
// r forms w_r in shared memory (m·s first, then an IEEE division by the
// exact integer count, as the TPU kernel's wrapper does:
// masked_agg.py:40-41). Then one owner thread per feature adds its rows in
// order 0..n-1 from shared memory, 16 rows at a time: the 16 codes are
// loaded and converted first (an integer add into a float's mantissa and
// one exact subtraction, at the FP32 rate rather than the slower rate of
// the int→float conversion), so the products run ahead of the chain of
// adds. The plain version (ref.masked_agg_ref) sums in the same order, so
// the two agree bit for bit (-fmad=false keeps each product rounded before
// its add).
#include "common.cuh"

namespace {

constexpr int kF = 128;                  // features, and threads, a block
constexpr int kWords = kF / 16 + 1;      // 16-byte words per row's tile
constexpr int kMaxRows = kF;             // rows a chunk stages: one a thread
constexpr int kGroup = 16;               // rows loaded ahead of their adds

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c exactly, for c in [-128, 127]: 2^23 + 128 + c, less 2^23 + 128
__device__ __forceinline__ float code_to_float(int8_t c) {
  return __int_as_float(0x4B000080 + c) - 8388736.f;
}

__global__ void __launch_bounds__(kF)
    masked_agg_kernel(const int8_t* __restrict__ cache,
                      const float* __restrict__ scales,
                      const bool* __restrict__ mask, float* __restrict__ out,
                      int n, long long d, int rows) {
  extern __shared__ uint4 tile[];           // rows × kWords
  __shared__ float w[kMaxRows];
  const int tid = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * kF;
  const uintptr_t first = reinterpret_cast<uintptr_t>(cache);
  const uintptr_t end = first + static_cast<uintptr_t>(n) * d;
  const unsigned step = static_cast<unsigned>(d & 15);
  const int8_t* bytes = reinterpret_cast<const int8_t*>(tile) + tid;

  float acc = 0.f, denom = 1.f;
  for (int c0 = 0; c0 < n; c0 += rows) {
    const int rc = min(rows, n - c0);
    // this thread's row of the chunk: its weight's operands load first
    const bool has = tid < rc;
    const bool m = has && mask[c0 + tid];
    const float sc = has ? scales[c0 + tid] : 0.f;
    // the chunk's copies, all issued before anything waits on them
    for (int t = tid; t < rc * kWords; t += kF) {
      const int r = t / kWords, k = t - r * kWords;
      const uintptr_t a =
          ((first + static_cast<uintptr_t>(c0 + r) * d + j0) & ~uintptr_t{15})
          + 16 * k;
      uint4* dst = &tile[t];
      if (a >= first && a + 16 <= end) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(smem_addr(dst)), "l"(a) : "memory");
      } else {
        int8_t* b = reinterpret_cast<int8_t*>(dst);
        for (int u = 0; u < 16; ++u)
          b[u] = a + u >= first && a + u < end
                     ? *reinterpret_cast<const int8_t*>(a + u) : 0;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (c0 == 0) {
      // Σ m: an integer count, exact (and order-free) like the f32 sum of
      // 0/1 in the plain version
      int total = __syncthreads_count(m);
      for (int i0 = rc; i0 < n; i0 += kF)
        total += __syncthreads_count(i0 + tid < n && mask[i0 + tid]);
      denom = fmaxf(static_cast<float>(total), 1.f);
    }
    if (has) w[tid] = (m ? 1.f : 0.f) * sc / denom;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // the owner of feature j0 + tid adds the chunk's rows in order; row r's
    // byte for it is at offset (its tile's phase) + tid in the row's words
    if (j0 + tid < d) {
      unsigned off = static_cast<unsigned>(
          (first + static_cast<uintptr_t>(c0) * d + j0) & 15);
      int r = 0;
      for (; r + kGroup <= rc; r += kGroup) {
        float v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          v[k] = code_to_float(
              bytes[(r + k) * 16 * kWords + ((off + k * step) & 15)]);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) acc = acc + w[r + k] * v[k];
        off = (off + kGroup * step) & 15;
      }
      for (; r < rc; ++r) {
        acc = acc + w[r] * code_to_float(bytes[r * 16 * kWords + off]);
        off = (off + step) & 15;
      }
    }
    __syncthreads();   // the chunk's readers are done before the next copies
  }
  if (j0 + tid < d) out[j0 + tid] = acc;
}

}  // namespace

// plan: `rows` (1..128) a chunk, `blocks` = ⌈d / 128⌉ of 128 threads. A plan
// that does not cover d or does not fit is refused (cudaErrorInvalidValue),
// never run.
REPRO_EXPORT int masked_agg(const void* cache, const void* scales,
                            const void* mask, void* out, int n, long long d,
                            int rows, long long blocks, void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  const bool ok = n >= 0 && rows >= 1 && rows <= kMaxRows && blocks >= 1 &&
                  blocks < (1LL << 31) && blocks * kF >= d;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  masked_agg_kernel<<<static_cast<unsigned>(blocks), kF,
                      static_cast<size_t>(rows) * kWords * 16,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cache), static_cast<const float*>(scales),
      static_cast<const bool*>(mask), static_cast<float*>(out), n, d, rows);
  return static_cast<int>(cudaGetLastError());
}
