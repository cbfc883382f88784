// One f32 row spread over a thread-block cluster, and the row's |max| agreed
// by the cluster's blocks: the pieces that quantize_rows (quant.cu), the
// fused int8 cache-row swap (row_delta.cu) and the whole int8 ACE step
// (cache_update.cu) share.
//
// A row is split over a cluster of C blocks (C = 1, 2, 4 or 8; the host plan,
// kernels/quant.py `_quant_plan`, picks C, the block size and where a block
// keeps its slice). Each block owns one contiguous slice (`RowSplit`): block
// 0 a scalar head up to x's next 16-byte boundary, every block a run of
// float4 vectors, block C-1 the scalar tail. A block keeps its slice in
// registers (`kRegisters`, 2, 4 or 8 vectors a thread), else in shared
// memory (`kShared`), else reads it twice (`kStream`).
//
// The exchange (`ClusterMax`): a block's |max| (warp shuffles, then one warp
// over the warps' maxima) is pushed through distributed shared memory into
// every cluster block, each push followed by an arrival on that block's
// mbarrier; a block waits for its C arrivals and combines the C maxima. max
// is order-free, so every block derives the same scale bits; NaN propagates
// through it, as through torch.amax. The push keeps the one cluster barrier,
// which guards the mbarriers' set-up, off the critical path: a pull
// (cluster.sync(), each block reading its peers' maxima, a second barrier
// before leaving) took 3.55 µs for quantize_rows at (1, 17,226) against the
// push's 2.94 (tools/quant_designs.py; NVIDIA H100 80GB HBM3, 700.00 W).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
// dynamic shared memory a kShared block may take: an SM's 227 KB less the
// block's static arrays
constexpr int kSmemBytes = 227 * 1024 - 1024;
enum OnChip { kRegisters = 0, kShared = 1, kStream = 2 };
// loads a thread keeps in flight per step of the shared and streaming loops
constexpr int kUnroll = 4;

// max that keeps a NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float abs_max4(float4 v, float m) {
  m = nan_max(fabsf(v.x), m);
  m = nan_max(fabsf(v.y), m);
  m = nan_max(fabsf(v.z), m);
  return nan_max(fabsf(v.w), m);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in cluster block `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float warp_max(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
  return m;
}

// Block `rank`'s share of a row of d f32 elements at xr, on a cluster of
// 2^log2c blocks: h head elements up to xr's 16-byte boundary, then nv
// float4 vectors of which this block owns [vlo, vhi), then tail elements.
// A thread owns at most one scalar, element ej (-1 for none): the head on
// threads [0, h) of rank 0, the tail on [3, 3 + tail) of rank C - 1.
struct RowSplit {
  long long h, nv, vlo, vhi, ej;

  __device__ __forceinline__ RowSplit(const float* xr, long long d, int rank,
                                      int log2c, int tid) {
    h = min(static_cast<long long>(
                ((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) >> 2),
            d);
    nv = (d - h) >> 2;
    const int tail = static_cast<int>((d - h) & 3);
    vlo = (rank * nv) >> log2c;
    vhi = ((rank + 1) * nv) >> log2c;
    ej = -1;
    if (rank == 0 && tid < h) ej = tid;
    if (rank == (1 << log2c) - 1 && tid >= 3 && tid < 3 + tail)
      ej = h + 4 * nv + tid - 3;
  }
};

// The same split over any number of blocks: block `rank` of `parts` owns
// the vectors [rank·nv/parts, (rank+1)·nv/parts), block 0 the head, block
// parts - 1 the tail (quant.cu's cooperative grid; kernels/quant.py
// `_quant_slices` mirrors both splits).
__device__ __forceinline__ RowSplit split_row(const float* xr, long long d,
                                              long long rank,
                                              long long parts, int tid) {
  RowSplit sp(xr, d, 0, 0, tid);       // the whole row, head and tail
  sp.vlo = rank * sp.nv / parts;
  sp.vhi = (rank + 1) * sp.nv / parts;
  if (sp.ej >= 0 && (sp.ej < sp.h ? rank != 0 : rank != parts - 1))
    sp.ej = -1;
  return sp;
}

// The exchange of the cluster blocks' maxima; one per block, in shared
// memory. Every thread calls `start` first, `combine` once its loads are in.
struct ClusterMax {
  float warp_part[kMaxThreads / 32];
  float part[8];                       // the maximum of each cluster block
  alignas(8) unsigned long long bar;   // mbarrier: C arrivals

  // Every block's barrier is set up before a peer arrives on it: the cluster
  // barrier's wait comes in `combine`, long after all arrived.
  __device__ __forceinline__ void start(int C) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&bar)), "r"(C) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  // The row's max over the cluster, from each thread's m. Lane k of warp 0
  // pushes the block's max into block k's part[rank] and arrives on block
  // k's barrier (a release at cluster scope: thread 0's earlier loads are
  // ordered before its arrival on rank 0), and every block waits for its C
  // arrivals. A block leaves only after all its peers have pushed to it, so
  // no push finds its target gone.
  __device__ __forceinline__ float combine(float m, int C, int rank) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    m = warp_max(m);
    if (lane == 0) warp_part[warp] = m;
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    const uint32_t b = smem_addr(&bar);
    if (warp == 0) {
      m = warp_max(lane < ((blockDim.x + 31) >> 5) ? warp_part[lane] : 0.f);
      if (lane < C) {
        asm volatile("st.shared::cluster.f32 [%0], %1;"
                     :: "r"(peer_addr(smem_addr(&part[rank]), lane)),
                        "f"(m) : "memory");
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
            :: "r"(peer_addr(b, lane)) : "memory");
      }
    }
    for (uint32_t done = 0; !done;) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "0;\nselp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(b) : "memory");
    }
    float r = 0.f;
    for (int k = 0; k < C; ++k) r = nan_max(part[k], r);
    return r;
  }
};

// Vector i (4 codes) of an int8 row run at cv: one char4 load where `c4`
// (cv is 4-byte aligned), else four byte loads.
__device__ __forceinline__ char4 load_codes(const int8_t* cv, long long i,
                                            bool c4) {
  if (c4) return reinterpret_cast<const char4*>(cv)[i];
  const int8_t* p = cv + 4 * i;
  return make_char4(p[0], p[1], p[2], p[3]);
}

// s = max(r, 1e-12) / 127 by IEEE division, clamped before dividing as
// kernels/ref.row_scale does (a NaN r stays NaN).
__device__ __forceinline__ float row_scale(float r) {
  return (r < 1e-12f ? 1e-12f : r) / 127.f;
}

// Whether a plan fits: `cluster` blocks a row of d elements, `threads` a
// block, the slice in registers (`per_thread` vectors a thread), shared
// memory or streamed. A plan that does not fit is refused, never run.
inline bool row_plan_fits(long long d, int cluster, int threads,
                          int per_thread, int on_chip) {
  const long long slice = ((d >> 2) + cluster - 1) / cluster;  // vectors
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         (on_chip != kRegisters ||
          ((per_thread == 2 || per_thread == 4 || per_thread == 8) &&
           slice <= static_cast<long long>(threads) * per_thread)) &&
         (on_chip != kShared || slice * 16 <= kSmemBytes) &&
         (on_chip >= kRegisters && on_chip <= kStream);
}

// Launch `kernel` on `blocks` blocks in clusters of `cluster` along x. A
// kernel that takes more than 48 KB of dynamic shared memory must have been
// allowed it (cudaFuncAttributeMaxDynamicSharedMemorySize) first.
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kernel)(P...), unsigned blocks, int cluster,
                           int threads, size_t smem, cudaStream_t stream,
                           A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro
