// The fused K-arrival server commit, in one pass over the features:
//     dequantize the K old rows              old_k = C[k]·old_s_k (or float)
//     requantize + write the K new rows      C'[k] = q(Ĝ_k) on valid lanes,
//                                            the old row bit-exact elsewhere
//     lane-weighted segment sums             S_Δ = Σ valid_k·(dq(new_k) − old_k)
//                                            S_A = Σ a_k·old_k, S_B = Σ b_k·old_k
//                                            S_G = Σ g_k·Ĝ_k
//     recombination                          [V'; upd] = mats @ [V; S_Δ; S_A; S_B; S_G]
// where Ĝ is the payload zeroed on invalid lanes (a quarantined lane may be
// NaN), `lanes` is the (6, K) block [old_s, new_s, valid, a, b, g] and
// `mats` the (R+1, R+4) block [coef; upd_w], R ≤ 3 running-sum vectors.
//
// Replaces the TPU kernel src/repro/kernels/commit_batch.py::commit_batch
// (pallas_call at commit_batch.py:116), called from flat_commit_batch for
// the K > 1 step of ACE, ACED and CA²FL.
//
// Bound on an H100: memory. Per feature, with int8 rows, it reads G (4K B),
// the old rows (K B) and V (4R B) and writes the new rows (K B), V' (4R B)
// and the update (4 B): K·(4+1+1) + 2R·4 + 4 bytes. At the vision task's
// d = 17,226, K = 16 and R = 3 that is 2.1 MB, about 0.6 µs at 3.35 TB/s —
// of the order of the launch latency, so on the engine's path the kernel is
// launch-bound. Its roughly 10K + 2(R+1)(R+4) flops per feature are far
// below the card's f32 rate.
// Design: a 1-D grid over feature tiles; each thread owns one column. The
// lanes and mats blocks go to shared memory once per block. The thread loops
// over the K lanes in registers (dequantize, requantize, store, accumulate
// the sums in a fixed order) and then applies the (R+1)×(R+4) recombination
// itself. No atomics and no cross-block reduction: the result is
// deterministic. Templated on the row type (int8, bf16, f32); lane weights
// absent at the call are template flags, and their sums are compiled out.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, bool HA, bool HB, bool HG>
__global__ void commit_batch_kernel(const float* __restrict__ G,
                                    const T* __restrict__ old_rows,
                                    const float* __restrict__ lanes,
                                    const float* __restrict__ mats,
                                    const float* __restrict__ V,
                                    T* __restrict__ new_rows,
                                    float* __restrict__ V_out,
                                    float* __restrict__ upd, int K, int R,
                                    long long d) {
  extern __shared__ float sh[];
  const int n_lanes = 6 * K;
  const int n_mats = (R + 1) * (R + 4);
  for (int x = threadIdx.x; x < n_lanes + n_mats; x += blockDim.x) {
    sh[x] = x < n_lanes ? lanes[x] : mats[x - n_lanes];
  }
  __syncthreads();
  const float* old_s = sh;
  const float* new_s = sh + K;
  const float* valid = sh + 2 * K;
  const float* wa = sh + 3 * K;
  const float* wb = sh + 4 * K;
  const float* wg = sh + 5 * K;
  const float* M = sh + n_lanes;

  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= d) return;

  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  float sd = 0.f, sa = 0.f, sb = 0.f, sg = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long o = static_cast<long long>(k) * d + i;
    const bool ok = valid[k] > 0.f;
    const float g = ok ? G[o] : 0.f;  // sanitize before any product
    const T c = old_rows[o];
    float old, dq_new;
    if constexpr (kQuant) {
      old = static_cast<float>(c) * old_s[k];
      const float q = repro::quant(g, new_s[k]);
      new_rows[o] = ok ? static_cast<int8_t>(q) : c;
      dq_new = q * new_s[k];
    } else {
      old = to_f32<T>(c);
      const T stored = from_f32<T>(g);
      new_rows[o] = ok ? stored : c;
      dq_new = to_f32<T>(stored);
    }
    if (ok) sd += dq_new - old;
    if constexpr (HA) sa += wa[k] * old;
    if constexpr (HB) sb += wb[k] * old;
    if constexpr (HG) sg += wg[k] * g;
  }

  const int cols = R + 4;
  for (int r = 0; r <= R; ++r) {
    const float* m = M + r * cols;
    float acc = 0.f;
    for (int v = 0; v < R; ++v) {
      acc += m[v] * V[static_cast<long long>(v) * d + i];
    }
    acc += m[R] * sd;
    if constexpr (HA) acc += m[R + 1] * sa;
    if constexpr (HB) acc += m[R + 2] * sb;
    if constexpr (HG) acc += m[R + 3] * sg;
    if (r < R) {
      V_out[static_cast<long long>(r) * d + i] = acc;
    } else {
      upd[i] = acc;
    }
  }
}

struct Args {
  const void* G;
  const void* old_rows;
  const void* lanes;
  const void* mats;
  const void* V;
  void* new_rows;
  void* V_out;
  void* upd;
  int K;
  int R;
  long long d;
  cudaStream_t stream;
};

template <typename T, bool HA, bool HB, bool HG>
void launch(const Args& a) {
  const size_t smem = sizeof(float) * (6 * a.K + (a.R + 1) * (a.R + 4));
  commit_batch_kernel<T, HA, HB, HG>
      <<<repro::blocks_for(a.d), repro::kThreads, smem, a.stream>>>(
          static_cast<const float*>(a.G), static_cast<const T*>(a.old_rows),
          static_cast<const float*>(a.lanes), static_cast<const float*>(a.mats),
          static_cast<const float*>(a.V), static_cast<T*>(a.new_rows),
          static_cast<float*>(a.V_out), static_cast<float*>(a.upd), a.K, a.R,
          a.d);
}

template <typename T>
void launch_flags(int flags, const Args& a) {
  switch (flags) {
    case 0: launch<T, false, false, false>(a); break;
    case 1: launch<T, true, false, false>(a); break;
    case 2: launch<T, false, true, false>(a); break;
    case 3: launch<T, true, true, false>(a); break;
    case 4: launch<T, false, false, true>(a); break;
    case 5: launch<T, true, false, true>(a); break;
    case 6: launch<T, false, true, true>(a); break;
    default: launch<T, true, true, true>(a); break;
  }
}

}  // namespace

// row_type: 0 int8, 1 bf16, 2 f32. lane_flags: bit 0 lane_a present, bit 1
// lane_b, bit 2 lane_g. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
REPRO_EXPORT int commit_batch(int row_type, int lane_flags, const void* G,
                              const void* old_rows, const void* lanes,
                              const void* mats, const void* V, void* new_rows,
                              void* V_out, void* upd, int K, int R,
                              long long d, void* stream) {
  if (K < 1 || R < 1 || lane_flags < 0 || lane_flags > 7 || row_type < 0 ||
      row_type > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d > 0) {
    const Args a{G, old_rows, lanes, mats, V, new_rows, V_out, upd, K, R, d,
                 static_cast<cudaStream_t>(stream)};
    if (row_type == 0) {
      launch_flags<int8_t>(lane_flags, a);
    } else if (row_type == 1) {
      launch_flags<__nv_bfloat16>(lane_flags, a);
    } else {
      launch_flags<float>(lane_flags, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
