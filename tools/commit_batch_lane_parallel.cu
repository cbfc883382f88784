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
// A second design of src/repro_torch/kernels/csrc/commit_batch.cu, with
// the same C interface and the same results bit for bit. The package does
// not build it: tools/commit_batch_designs.py builds it in place of the
// package's source and times the two on the card (PERF.md §6). The
// int8 codes come from repro::quant_fast, the package kernel's multiply by
// 1/new_s with the division near a tie.
//
// Bound on an H100: memory. Per feature, with int8 rows, it reads G (4K B),
// the old rows (K B) and V (4R B) and writes the new rows (K B), V' (4R B)
// and the update (4 B): K·(4+1+1) + 2R·4 + 4 bytes. At the vision task's
// d = 17,226, K = 16 and R = 3 that is 2.1 MB, about 0.6 µs at 3.35 TB/s,
// so at the engine's shape the kernel is bound by latency: how many loads
// are in flight at once and how many SMs hold work.
//
// Design. A block owns a tile of 128 features and all K lanes (16 at a
// time). Phase 1 is lane-parallel: one warp per lane row, each thread 4
// consecutive features, loaded and stored as one vector (float4 for G and
// f32 rows, 8 bytes of bf16, 4 bytes of int8), so all 16·128 elements of
// the tile are in flight at once and d = 17,226 gives 135 blocks for the
// 132 SMs. It writes each lane's per-feature terms — the masked
// dq(new) − old, old and Ĝ — to shared memory. Phase 2, after a barrier:
// one thread per feature sums them over k = 0..K−1 in order, with the same
// products as the plain version (ref.commit_batch_ref), then applies the
// recombination (the thread loaded its V values before phase 1). No atomics
// and no cross-block reduction: bit-identical to the plain version.
//
// Alignment. A (K, d) row starts on a vector boundary only when k·d is a
// multiple of 4 (d = 17,226 ≡ 2 mod 4). Each row keeps its wide loads: the
// row's first boundary at or after the tile start is h features in; 31
// threads take the vectors from there, and the last thread of the warp
// takes the h head and 4 − h tail features as scalars. Shared memory keeps
// each lane row shifted by its misalignment, so the vector stores there are
// aligned too and phase 2 reads without bank conflicts. Operands whose base
// addresses disagree on alignment take scalar loads throughout.
//
// K = 16, the engine's batch, is a compile-time instantiation (one chunk
// of lanes, loops unrolled); every other K runs the generic instantiation,
// 16 lanes per chunk with the sums carried across chunks in registers.
// Templated on the row type (int8, bf16, f32); lane weights absent at the
// call (null pointers) are template flags, and their sums compile out. All
// per-lane scalars and the recombination matrix are read from device
// memory through their own pointers and staged in shared memory: the
// binding launches this kernel and nothing else.
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 128;         // features per block
constexpr int kLanes = 16;         // lane rows staged at once
constexpr int kSlots = kTile / 4;  // 4-feature slots per lane row: a warp
constexpr int kPerThread = 4;      // lane rows per thread
constexpr int kBlock = kLanes / kPerThread * kSlots;  // 128 threads
constexpr int kRow = kTile + 4;    // a staged lane row, shift included
constexpr int kVecRegs = 3;        // V values held in registers
static_assert(kSlots == 32, "a warp covers a lane row of a tile");
static_assert(kBlock >= kTile, "phase 2 has a thread for every feature");

// Row types: the stored element, and the 4-element vector moved by one load.
struct RowI8 {
  using S = int8_t;
  using W = int;
  static constexpr bool kQuant = true;
};
struct RowBF16 {  // raw bits: bf16 -> f32 is a shift, f32 -> bf16 rounds
  using S = uint16_t;
  using W = uint2;
  static constexpr bool kQuant = false;
};
struct RowF32 {
  using S = float;
  using W = float4;
  static constexpr bool kQuant = false;
};

template <typename Row>
union Pack {
  typename Row::W w;
  typename Row::S e[4];
};

__device__ __forceinline__ float widen(int8_t c) {
  return static_cast<float>(c);
}
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen(float x) { return x; }

// One (lane, feature) of the commit: returns the element to store and sets
// the three per-feature terms the sums read. `g_raw` is ignored on an
// invalid lane (Ĝ = 0 there, before any product).
template <typename Row>
__device__ __forceinline__ typename Row::S commit_elem(
    float g_raw, typename Row::S c, bool ok, float os, float ns, float inv,
    float& term, float& old, float& g) {
  using S = typename Row::S;
  g = ok ? g_raw : 0.f;
  float dq_new;
  S out;
  if constexpr (Row::kQuant) {
    old = widen(c) * os;
    float q;
    if (!repro::quant_fast(g, inv, q)) q = repro::quant(g, ns);
    out = ok ? static_cast<S>(q) : c;
    dq_new = q * ns;
  } else {
    old = widen(c);
    S stored;
    if constexpr (std::is_same<S, float>::value) {
      stored = g;
    } else {
      stored = __bfloat16_as_ushort(__float2bfloat16_rn(g));
    }
    out = ok ? stored : c;
    dq_new = widen(stored);
  }
  term = dq_new - old;
  return out;
}

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
  int mis;  // base misalignment of G, old and new rows in elements mod 4,
            // or -1 when they disagree
  long long d;
};

// Per-block staging: each lane row's terms, shifted right by the row's
// misalignment (so phase 1's vector stores land on 16-byte boundaries), and
// the lanes' weights.
template <bool HO, bool HG>
struct alignas(16) Terms {
  float delta[kLanes][kRow];
  float old[HO ? kLanes : 1][kRow];
  float g[HG ? kLanes : 1][kRow];
  float wa[kLanes];
  float wb[kLanes];
  float wg[kLanes];
};

// Elements past the last vector boundary at the start of a tile of lane
// row `row` (tiles start at multiples of 4), or -1 for scalar operands.
__device__ __forceinline__ int row_offset(int mis, long long row) {
  return mis < 0 ? -1 : static_cast<int>((mis + row) & 3);
}

// Where this thread's 4 features of a lane row lie, as offsets in the tile:
// 4 from the row's first vector boundary on, or, in the last slot of a row
// that starts off a boundary, the h head features and the 4 − h tail ones.
// `vec`: one vector moves all 4. `shift`: the staged row's offset.
struct SlotMap {
  int at[4];
  bool vec;
  int shift;
};

__device__ __forceinline__ SlotMap slot_map(int mis, long long row, int slot,
                                            int rem) {
  const int e = row_offset(mis, row);
  const int h = e > 0 ? 4 - e : 0;
  const bool split = e > 0 && slot == kSlots - 1;
  SlotMap m;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m.at[c] = split ? (c < h ? c : kTile - 4 + c) : h + 4 * slot + c;
  }
  m.vec = e >= 0 && !split && m.at[3] < rem;
  m.shift = e > 0 ? e : 0;
  return m;
}

// One lane row's inputs for this thread's 4 features, loaded.
template <typename Row>
struct LaneIn {
  Pack<Row> c;
  float g[4];
  float os, ns, inv, wa, wb, wg;
  bool ok;
};

template <typename Row, bool HA, bool HB, bool HG>
__device__ __forceinline__ void load_lane(const Params& p, int k, int slot,
                                          long long f0, int rem,
                                          LaneIn<Row>& x) {
  using S = typename Row::S;
  const long long row = static_cast<long long>(k) * p.d;
  const SlotMap m = slot_map(p.mis, row, slot, rem);
  const float* G = p.G + row + f0;
  const S* C = static_cast<const S*>(p.old_rows) + row + f0;
  x.ok = p.valid[k] != 0;
  x.os = x.ns = x.inv = 1.f;
  x.wa = x.wb = x.wg = 0.f;
  if constexpr (Row::kQuant) {
    x.os = p.old_s[k];
    x.ns = p.new_s[k];
    const float inv = 1.f / x.ns;
    x.inv = isfinite(inv) ? inv : __int_as_float(0x7fffffff);  // NaN
  }
  if constexpr (HA) x.wa = p.lane_a[k];
  if constexpr (HB) x.wb = p.lane_b[k];
  if constexpr (HG) x.wg = p.lane_g[k];
  if (m.vec) {
    x.c.w = *reinterpret_cast<const typename Row::W*>(C + m.at[0]);
    const float4 gv = *reinterpret_cast<const float4*>(G + m.at[0]);
    x.g[0] = gv.x;
    x.g[1] = gv.y;
    x.g[2] = gv.z;
    x.g[3] = gv.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = m.at[c] < rem;
      x.c.e[c] = in ? C[m.at[c]] : S{};
      x.g[c] = in ? G[m.at[c]] : 0.f;
    }
  }
}

// Requantize and store the lane row's 4 features, and stage their terms
// (and, from slot 0, the lane's weights) as row `lane` of the chunk.
template <typename Row, bool HA, bool HB, bool HG, typename Sm>
__device__ __forceinline__ void commit_lane(const Params& p, Sm& sm, int k,
                                            int lane, int slot, long long f0,
                                            int rem, const LaneIn<Row>& x) {
  using S = typename Row::S;
  constexpr bool HO = HA || HB;
  const long long row = static_cast<long long>(k) * p.d;
  const SlotMap m = slot_map(p.mis, row, slot, rem);
  S* N = static_cast<S*>(p.new_rows) + row + f0;
  Pack<Row> out;
  float t[4], o[4], gs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out.e[c] = commit_elem<Row>(x.g[c], x.c.e[c], x.ok, x.os, x.ns, x.inv,
                                t[c], o[c], gs[c]);
    t[c] = x.ok ? t[c] : 0.f;  // S_Δ adds 0 for an invalid lane, as the
                               // plain version's where(valid, ·, 0) does
  }
  if (m.vec) {
    *reinterpret_cast<typename Row::W*>(N + m.at[0]) = out.w;
    const int a = m.at[0] + m.shift;  // a multiple of 4
    *reinterpret_cast<float4*>(&sm.delta[lane][a]) =
        make_float4(t[0], t[1], t[2], t[3]);
    if constexpr (HO) {
      *reinterpret_cast<float4*>(&sm.old[lane][a]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    if constexpr (HG) {
      *reinterpret_cast<float4*>(&sm.g[lane][a]) =
          make_float4(gs[0], gs[1], gs[2], gs[3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (m.at[c] < rem) {
        N[m.at[c]] = out.e[c];
        const int a = m.at[c] + m.shift;
        sm.delta[lane][a] = t[c];
        if constexpr (HO) sm.old[lane][a] = o[c];
        if constexpr (HG) sm.g[lane][a] = gs[c];
      }
    }
  }
  if (slot == 0) {
    if constexpr (HA) sm.wa[lane] = x.wa;
    if constexpr (HB) sm.wb[lane] = x.wb;
    if constexpr (HG) sm.wg[lane] = x.wg;
  }
}

// KS: the lane count when fixed at compile time (16), or 0 for any K.
template <typename Row, bool HA, bool HB, bool HG, int KS>
__global__ void __launch_bounds__(kBlock)
    commit_batch_kernel(const Params p) {
  __shared__ Terms<HA || HB, HG> sm;
  extern __shared__ float sh_mats[];  // (R+1, R+4): coef rows, then upd_w

  const int K = KS > 0 ? KS : p.K;
  const int R = p.R;
  const long long d = p.d;
  const int warp = threadIdx.x >> 5;
  const int slot = threadIdx.x & 31;
  const long long f0 = static_cast<long long>(blockIdx.x) * kTile;
  const int f = threadIdx.x;  // phase 2: threads < kTile own a feature
  const long long i = f0 + f;
  const bool owner = f < kTile && i < d;

  // loads first, stores after phase 1's loads are in flight: the
  // recombination matrix (one element a thread), the owner's V values
  const int n_coef = R * (R + 4);
  const int n_mats = n_coef + R + 4;
  const int x = threadIdx.x;
  const float m_x = x < n_coef ? p.coef[x] : (x < n_mats ? p.upd_w[x - n_coef]
                                                         : 0.f);
  float v_pre[kVecRegs];
#pragma unroll
  for (int v = 0; v < kVecRegs; ++v) {
    v_pre[v] = (owner && v < R) ? p.V[v * d + i] : 0.f;
  }

  float sd = 0.f, sa = 0.f, sb = 0.f, sg = 0.f;
  const int rem = d - f0 < kTile ? static_cast<int>(d - f0) : kTile;
  for (int k0 = 0; k0 < K; k0 += kLanes) {
    // phase 1: every load of the thread's lane rows first, then the stores
    LaneIn<Row> in[kPerThread];
#pragma unroll
    for (int l = 0; l < kPerThread; ++l) {
      const int k = k0 + warp * kPerThread + l;
      if (k < K) load_lane<Row, HA, HB, HG>(p, k, slot, f0, rem, in[l]);
    }
#pragma unroll
    for (int l = 0; l < kPerThread; ++l) {
      const int lane = warp * kPerThread + l;
      if (k0 + lane < K) {
        commit_lane<Row, HA, HB, HG>(p, sm, k0 + lane, lane, slot, f0, rem,
                                     in[l]);
      }
    }
    if (k0 == 0) {
      if (x < n_mats) sh_mats[x] = m_x;
      for (int y = x + kBlock; y < n_mats; y += kBlock) {
        sh_mats[y] = y < n_coef ? p.coef[y] : p.upd_w[y - n_coef];
      }
    }
    __syncthreads();
    if (owner) {
      const int n = K - k0 < kLanes ? K - k0 : kLanes;
#pragma unroll
      for (int kk = 0; kk < kLanes; ++kk) {
        if (kk < n) {
          const int e = row_offset(p.mis, static_cast<long long>(k0 + kk) * d);
          const int a = f + (e > 0 ? e : 0);
          sd += sm.delta[kk][a];
          if constexpr (HA) sa += sm.wa[kk] * sm.old[kk][a];
          if constexpr (HB) sb += sm.wb[kk] * sm.old[kk][a];
          if constexpr (HG) sg += sm.wg[kk] * sm.g[kk][a];
        }
      }
    }
    if (k0 + kLanes < K) __syncthreads();  // the next chunk restages
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

template <typename Row, bool HA, bool HB, bool HG, int KS>
void launch(const Params& p, cudaStream_t stream) {
  const auto kernel = commit_batch_kernel<Row, HA, HB, HG, KS>;
  const size_t smem = sizeof(float) * (p.R + 1) * (p.R + 4);
  if (smem + sizeof(Terms<HA || HB, HG>) > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long blocks = (p.d + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kBlock, smem, stream>>>(p);
}

template <typename Row, int KS>
void launch_flags(const Params& p, cudaStream_t s) {
  const int flags = (p.lane_a != nullptr) | (p.lane_b != nullptr) << 1 |
                    (p.lane_g != nullptr) << 2;
  switch (flags) {
    case 0: launch<Row, false, false, false, KS>(p, s); break;
    case 1: launch<Row, true, false, false, KS>(p, s); break;
    case 2: launch<Row, false, true, false, KS>(p, s); break;
    case 3: launch<Row, true, true, false, KS>(p, s); break;
    case 4: launch<Row, false, false, true, KS>(p, s); break;
    case 5: launch<Row, true, false, true, KS>(p, s); break;
    case 6: launch<Row, false, true, true, KS>(p, s); break;
    default: launch<Row, true, true, true, KS>(p, s); break;
  }
}

int element_offset(const void* x, size_t size) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x) / size) & 3);
}

template <typename Row>
void launch_rows(Params p, cudaStream_t s) {
  const size_t size = sizeof(typename Row::S);
  const int m = element_offset(p.G, sizeof(float));
  p.mis = (m == element_offset(p.old_rows, size) &&
           m == element_offset(p.new_rows, size)) ? m : -1;
  if (p.K == kLanes) {
    launch_flags<Row, kLanes>(p, s);
  } else {
    launch_flags<Row, 0>(p, s);
  }
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
                   -1,
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
