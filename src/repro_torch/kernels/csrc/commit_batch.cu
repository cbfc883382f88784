// The fused K-arrival server commit, in one pass over the features:
//     dequantize the K old rows              old_k = C[k]·old_s_k (or float)
//     requantize + write the K new rows      C'[k] = q(Ĝ_k) on valid lanes,
//                                            the old row bit-exact elsewhere
//     lane-weighted segment sums             S_Δ = Σ valid_k·(dq(new_k) − old_k)
//                                            S_A = Σ a_k·old_k, S_B = Σ b_k·old_k
//                                            S_G = Σ g_k·Ĝ_k
//     recombination                          [V'; upd] = mats @ [V; S_Δ; S_A; S_B; S_G]
// where Ĝ is the payload zeroed on invalid lanes (a quarantined lane may be
// NaN) and mats = [coef; upd_w] is (R+1, R+4).
//
// Replaces the TPU kernel src/repro/kernels/commit_batch.py::commit_batch
// (pallas_call at commit_batch.py:116), called from flat_commit_batch for
// the K > 1 step of ACE, ACED and CA²FL.
//
// Bound on an H100: memory. Per feature, with int8 rows, it reads G (4K B),
// the old rows (K B) and V (4R B) and writes the new rows (K B), V' (4R B)
// and the update (4 B): K·(4+1+1) + 2R·4 + 4 bytes. At the vision task's
// d = 17,226, K = 16 and R = 3 that is 2.1 MB, about 0.6 µs at 3.35 TB/s,
// so at the engine's shape the kernel is bound by latency: how much of the
// per-element work runs at once, and how many SMs hold it.
//
// Design. A thread owns one feature and walks the lanes in order. Every
// load of a chunk of 16 lanes (G, the old row, V) is issued before the
// first is used, so a thread waits for memory once per chunk; a warp's
// loads of a lane row are 32 consecutive features, whole 32-byte sectors
// for int8 rows too, so no load depends on how a row is aligned. The sums
// stay in registers in lane order — the plain version's order
// (ref.commit_batch_ref) — so the result is bit-identical to it, with no
// shared-memory round trip and no barrier between phases. The per-lane
// scalars (valid, old_s, new_s, the weights) and the recombination matrix
// reach the kernel through their own pointers (absent ones are null and
// compile out) and are staged in shared memory once per block: the binding
// launches this kernel and nothing else. (A lane-parallel layout — a warp
// per lane row, 4 features a thread in one vector, the terms summed out of
// shared memory after a barrier, tools/commit_batch_lane_parallel.cu —
// measured slower at both the engine's d and 2^24+3 on the H100: the
// barrier idles most of a block while a quarter of it sums, and the
// staging costs shared-memory traffic per element; PERF.md §6.)
//
// The int8 requantization divides by new_s once per lane and block, and
// multiplies per element (repro::quant_fast: the same bits as the
// division, which the kernel takes instead near a rounding tie). A thread
// decides kGroup lanes' codes before it stores them, so the rare division
// sits outside the straight-line code.
//
// Small d leaves the work thin: the engine's 17,226 features are 135
// blocks of 128 threads, one warp per scheduler of each SM, and each warp's
// 16 lanes of int8 work lie exposed. Below eight warps per SM the kernel
// splits a feature's 16 lanes of int8 rows over kSplit threads of one
// warp; each computes its lanes' terms, and the feature's first thread adds
// them in lane order, fetched with warp shuffles. Float rows (less work a
// lane: the shuffles cost more than they save) and large d keep one thread
// per feature. K = 16,
// the engine's batch, is a compile-time instantiation (one chunk, loops
// unrolled); every other K runs the generic one, chunk by chunk, with the
// sums carried in registers. Templated on the row type (int8, bf16, f32).
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 16;     // lanes staged at once
constexpr int kSplit = 2;      // threads per feature: int8, small d, K = 16
constexpr int kGroup = 4;      // lanes quantized before their stores
constexpr int kVecRegs = 3;    // V values held in registers
constexpr unsigned kAll = 0xffffffffu;

// Row types: the stored element (bf16 as its raw bits: bf16 -> f32 is a
// shift, f32 -> bf16 rounds to nearest even).
struct RowI8 {
  using S = int8_t;
  static constexpr bool kQuant = true;
};
struct RowBF16 {
  using S = uint16_t;
  static constexpr bool kQuant = false;
};
struct RowF32 {
  using S = float;
  static constexpr bool kQuant = false;
};

__device__ __forceinline__ float widen(int8_t c) {
  return static_cast<float>(c);
}
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen(float x) { return x; }

struct Params {
  const float* G;
  const void* old_rows;
  const float* old_s;
  const float* new_s;
  const uint8_t* valid;
  const float* lane_a;
  const float* lane_b;
  const float* lane_g;
  const float* coef;
  const float* upd_w;
  const float* V;
  void* new_rows;
  float* V_out;
  float* upd;
  int K;
  int R;
  long long d;
};

// KS: the lane count when fixed at compile time (16), or 0 for any K.
// TPF: threads per feature, each taking kChunk / TPF consecutive lanes.
template <typename Row, bool HA, bool HB, bool HG, int KS, int TPF>
__global__ void __launch_bounds__(kThreads)
    commit_batch_kernel(const Params p) {
  static_assert(TPF == 1 || KS == kChunk, "a split needs K = one chunk");
  static_assert(kChunk / TPF % kGroup == 0, "whole groups of lanes");
  constexpr int kW = 32 / TPF;        // features per warp
  constexpr int kL = kChunk / TPF;    // lanes per thread and chunk
  constexpr int kF = kThreads / TPF;  // features per block
  using S = typename Row::S;
  __shared__ float4 s_q[kChunk];      // old_s, new_s, 1 / new_s, valid
  __shared__ float4 s_w[kChunk];      // lane_a, lane_b, lane_g
  extern __shared__ float sh_mats[];  // (R+1, R+4): coef rows, then upd_w

  const int K = KS > 0 ? KS : p.K;
  const int R = p.R;
  const long long d = p.d;
  const int t = threadIdx.x;
  const int part = (t & 31) / kW;  // which kL lanes of the chunk
  const long long i = static_cast<long long>(blockIdx.x) * kF +
                      (t >> 5) * kW + (t & (kW - 1));
  const bool live = i < d;
  const bool owner = live && part == 0;  // sums, recombines, writes V', u
  const S* C = static_cast<const S*>(p.old_rows);
  S* N = static_cast<S*>(p.new_rows);

  // loads first: the recombination matrix (an element a thread), V
  const int n_coef = R * (R + 4);
  const int n_mats = n_coef + R + 4;
  const float m_t = t < n_coef ? p.coef[t]
                               : (t < n_mats ? p.upd_w[t - n_coef] : 0.f);
  float v_pre[kVecRegs];
#pragma unroll
  for (int v = 0; v < kVecRegs; ++v) {
    v_pre[v] = (owner && v < R) ? p.V[v * d + i] : 0.f;
  }

  float sd = 0.f, sa = 0.f, sb = 0.f, sg = 0.f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = K - k0 < kChunk ? K - k0 : kChunk;
    const int kp = part * kL;  // this thread's first lane in the chunk
    float g[kL];
    S c[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const bool in = live && kp + j < n;
      const long long o = static_cast<long long>(k0 + kp + j) * d + i;
      g[j] = in ? p.G[o] : 0.f;
      c[j] = in ? C[o] : S{};
    }
    float4 q4 = make_float4(1.f, 1.f, 1.f, 0.f);
    float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < n) {
      const int k = k0 + t;
      q4.w = p.valid[k] ? 1.f : 0.f;
      if constexpr (Row::kQuant) {
        q4.x = p.old_s[k];
        q4.y = p.new_s[k];
      }
      if constexpr (HA) w4.x = p.lane_a[k];
      if constexpr (HB) w4.y = p.lane_b[k];
      if constexpr (HG) w4.z = p.lane_g[k];
    }
    if (k0 > 0) __syncthreads();  // the last chunk's readers are done
    if (t < n) {
      if constexpr (Row::kQuant) {
        const float inv = 1.f / q4.y;
        q4.z = isfinite(inv) ? inv : __int_as_float(0x7fffffff);  // NaN
      }
      s_q[t] = q4;
      s_w[t] = w4;
    }
    if (k0 == 0) {
      if (t < n_mats) sh_mats[t] = m_t;
      for (int y = t + kThreads; y < n_mats; y += kThreads) {
        sh_mats[y] = y < n_coef ? p.coef[y] : p.upd_w[y - n_coef];
      }
    }
    __syncthreads();

    // this thread's lanes, kGroup at a time: the int8 codes by one
    // multiply each, by the division only where the multiply cannot decide
    // (near a tie: rare, out of line); then store the new rows and form the
    // summed terms, the owner adding its own lanes (the chunk's first) at once
    float td[kL], ta[kL], tb[kL], tg[kL];
#pragma unroll
    for (int j0 = 0; j0 < kL; j0 += kGroup) {
      float qv[kGroup];
      if constexpr (Row::kQuant) {
        unsigned divide = 0;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float4 q = s_q[kp + j0 + u];
          const float gk = q.w > 0.f ? g[j0 + u] : 0.f;
          if (!repro::quant_fast(gk, q.z, qv[u])) divide |= 1u << u;
        }
        if (divide != 0) {
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            if (divide >> u & 1u) {
              const float4 q = s_q[kp + j0 + u];
              qv[u] = repro::quant(q.w > 0.f ? g[j0 + u] : 0.f, q.y);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = j0 + u;
        const float4 q = s_q[kp + j];
        const float4 w = s_w[kp + j];
        const bool ok = q.w > 0.f;
        const float gk = ok ? g[j] : 0.f;  // sanitize before any product
        float old, dq_new;
        S out;
        if constexpr (Row::kQuant) {
          old = widen(c[j]) * q.x;
          out = ok ? static_cast<S>(qv[u]) : c[j];
          dq_new = qv[u] * q.y;
        } else {
          old = widen(c[j]);
          S stored;
          if constexpr (std::is_same<S, float>::value) {
            stored = gk;
          } else {
            stored = __bfloat16_as_ushort(__float2bfloat16_rn(gk));
          }
          out = ok ? stored : c[j];
          dq_new = widen(stored);
        }
        if (live && kp + j < n) {
          N[static_cast<long long>(k0 + kp + j) * d + i] = out;
        }
        // an invalid lane adds 0 to S_Δ, as the plain version's
        // where(valid, ·, 0) does
        td[j] = ok ? dq_new - old : 0.f;
        ta[j] = w.x * old;
        tb[j] = w.y * old;
        tg[j] = w.z * gk;
        if (j < n) {
          sd += td[j];
          if constexpr (HA) sa += ta[j];
          if constexpr (HB) sb += tb[j];
          if constexpr (HG) sg += tg[j];
        }
      }
    }
    // then each other part's lanes in order, from the thread q·kW places
    // further on in the warp
#pragma unroll
    for (int q = 1; q < TPF; ++q) {
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const float xd = __shfl_down_sync(kAll, td[j], q * kW);
        const float xa = HA ? __shfl_down_sync(kAll, ta[j], q * kW) : 0.f;
        const float xb = HB ? __shfl_down_sync(kAll, tb[j], q * kW) : 0.f;
        const float xg = HG ? __shfl_down_sync(kAll, tg[j], q * kW) : 0.f;
        if (q * kL + j < n) {
          sd += xd;
          if constexpr (HA) sa += xa;
          if constexpr (HB) sb += xb;
          if constexpr (HG) sg += xg;
        }
      }
    }
  }
  if (!owner) return;

  const int cols = R + 4;
  for (int r = 0; r <= R; ++r) {
    const float* m = sh_mats + r * cols;
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < kVecRegs; ++v) {
      if (v < R) acc += m[v] * v_pre[v];
    }
    for (int v = kVecRegs; v < R; ++v) acc += m[v] * p.V[v * d + i];
    acc += m[R] * sd;
    if constexpr (HA) acc += m[R + 1] * sa;
    if constexpr (HB) acc += m[R + 2] * sb;
    if constexpr (HG) acc += m[R + 3] * sg;
    if (r < R) {
      p.V_out[r * d + i] = acc;
    } else {
      p.upd[i] = acc;
    }
  }
}

template <typename Row, bool HA, bool HB, bool HG, int KS, int TPF>
void launch(const Params& p, cudaStream_t stream) {
  const auto kernel = commit_batch_kernel<Row, HA, HB, HG, KS, TPF>;
  const size_t smem = sizeof(float) * (p.R + 1) * (p.R + 4);
  if (smem > 40 * 1024) {  // beyond the default once the static part counts
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long features = kThreads / TPF;
  const long long blocks = (p.d + features - 1) / features;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
}

template <typename Row, int KS, int TPF>
void launch_flags(const Params& p, cudaStream_t s) {
  const int flags = (p.lane_a != nullptr) | (p.lane_b != nullptr) << 1 |
                    (p.lane_g != nullptr) << 2;
  switch (flags) {
    case 0: launch<Row, false, false, false, KS, TPF>(p, s); break;
    case 1: launch<Row, true, false, false, KS, TPF>(p, s); break;
    case 2: launch<Row, false, true, false, KS, TPF>(p, s); break;
    case 3: launch<Row, true, true, false, KS, TPF>(p, s); break;
    case 4: launch<Row, false, false, true, KS, TPF>(p, s); break;
    case 5: launch<Row, true, false, true, KS, TPF>(p, s); break;
    case 6: launch<Row, false, true, true, KS, TPF>(p, s); break;
    default: launch<Row, true, true, true, KS, TPF>(p, s); break;
  }
}

// Fewer than eight warps per SM with one thread per feature (two per
// scheduler): split the lanes. The SM count is read once, from the device
// of the first call.
bool few_warps(long long d) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return d < 8LL * 32 * sms;
}

template <typename Row>
void launch_rows(const Params& p, cudaStream_t s) {
  if (p.K != kChunk) {
    launch_flags<Row, 0, 1>(p, s);
    return;
  }
  if constexpr (Row::kQuant) {
    if (few_warps(p.d)) {
      launch_flags<Row, kChunk, kSplit>(p, s);
      return;
    }
  }
  launch_flags<Row, kChunk, 1>(p, s);
}

}  // namespace

// row_type: 0 int8 (old_s and new_s given), 1 bf16, 2 f32 (both null).
// valid is K bytes (a bool tensor); lane_a/lane_b/lane_g are null when
// absent. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
REPRO_EXPORT int commit_batch(int row_type, const void* G,
                              const void* old_rows, const void* old_s,
                              const void* new_s, const void* valid,
                              const void* lane_a, const void* lane_b,
                              const void* lane_g, const void* coef,
                              const void* upd_w, const void* V,
                              void* new_rows, void* V_out, void* upd, int K,
                              int R, long long d, void* stream) {
  const bool quantized = row_type == 0;
  if (K < 1 || R < 1 || row_type < 0 || row_type > 2 ||
      (old_s != nullptr) != quantized || (new_s != nullptr) != quantized) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d > 0) {
    const Params p{static_cast<const float*>(G),
                   old_rows,
                   static_cast<const float*>(old_s),
                   static_cast<const float*>(new_s),
                   static_cast<const uint8_t*>(valid),
                   static_cast<const float*>(lane_a),
                   static_cast<const float*>(lane_b),
                   static_cast<const float*>(lane_g),
                   static_cast<const float*>(coef),
                   static_cast<const float*>(upd_w),
                   static_cast<const float*>(V),
                   new_rows,
                   static_cast<float*>(V_out),
                   static_cast<float*>(upd),
                   K,
                   R,
                   d};
    const auto s = static_cast<cudaStream_t>(stream);
    if (row_type == 0) {
      launch_rows<RowI8>(p, s);
    } else if (row_type == 1) {
      launch_rows<RowBF16>(p, s);
    } else {
      launch_rows<RowF32>(p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
