// The whole int8 ACE incremental step (paper Alg. a.5 with the App. F.3.3
// int8 cache), K = 1 arrival per tick, in one launch: for the cache (data
// (n, d) int8, scale (n,) f32), the row index j (a device int64), the
// payload g (d,) f32, the running mean u (d,) (f32 or bf16) and inv_n = 1/n
// (f32, by value),
//     s       = max(max|g|, 1e-12) / 127               (new scale)
//     u'      = u + (q(g)·s − data[j]·scale[j])·inv_n   (f32, u's type)
//     data[j] = q(g),  scale[j] = s                     (in place)
// u is read and never written: u' is a fresh tensor (the engine keeps the
// old u for a frozen tick).
//
// Replaces the TPU kernel src/repro/kernels/cache_update.py::cache_row_update
// (pallas_call at cache_update.py:67), whose function (u' and c' given both
// scales) keeps its plain version, kernels/ref.cache_row_update_ref; on the
// TPU the scale, the gather and the scatter around it fused into the one
// jitted program of ACEIncremental.step. Here the plain version of the whole
// call is kernels/ref.set_row_ace_ref, a dozen PyTorch kernels.
//
// Bound on an H100: memory. Per feature it reads g and u (4 B each for an
// f32 state) and the old code (1 B) and writes the new code (1 B) and u'
// (4 B): 14 B. At the vision task's d = 17,226 that is 241 KB, about 72 ns
// at 3.35 TB/s, far below the launch latency: the call is latency-bound,
// and what counts is one launch in place of a chain, how many SMs share the
// row and how few dependent steps each takes.
//
// Design: row_delta.cu's, with u beside the row. The row is spread over a
// thread-block cluster and its |max| agreed through distributed shared
// memory (cluster_row.cuh); the plan is kernels/cache_update.py
// `_ace_plan`, quantize_rows' for one row. A block loads its slice of g,
// its old codes and its slice of u into registers, every load issued before
// the exchange (u's stay out of the max pass, so their latency hides behind
// the exchange). Thread 0 of each block reads scale[j] before the block pushes
// its maximum; rank 0 overwrites it only once its wait has seen all C
// arrivals, each a release at cluster scope after that read, so no block
// reads the new scale as the old one. Each code of the row is read and
// written by the same thread. A thread holds kV = 2 vectors of each: at 4
// a 1024-thread block (64 registers a thread) spilled 124-178 bytes a
// thread (ptxas, sm_90a), so a row longer than 8 blocks of 1024 threads at
// 2 vectors (65,536 features) goes to a cooperative grid over the whole
// card instead (below), as row_delta's longer rows do. u is read as f32 (a
// bf16 u exactly), the sum taken in f32 and rounded once to u's type
// (__float2bfloat16_rn, what .to(torch.bfloat16) does). u and u' are
// moved four elements at a time (float4, or 8 bytes of bf16) where they
// share g's 16-byte phase, else one at a time; the codes as char4 where the
// row's codes are 4-byte aligned there, else byte by byte.
// A j outside [0, n) is clamped, as JAX's dynamic_index_in_dim clamps.
#include <cuda_bf16.h>

#include "cluster_row.cuh"

namespace {

using repro::kMaxThreads;
using repro::kUnroll;
using repro::load_codes;
enum Place { kCluster = 0, kGrid = 1 };
constexpr int kV = 2;   // vectors a thread of the cluster kernel

// The state's type: four elements read into a float4 and written from one,
// as one vector where `vec` (the address is aligned for it), else one by one.
__device__ __forceinline__ float4 load_state(const float* p, long long i,
                                             bool vec) {
  if (vec) return reinterpret_cast<const float4*>(p)[i];
  p += 4 * i;
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float4 load_state(const __nv_bfloat16* p,
                                             long long i, bool vec) {
  __nv_bfloat162 a, b;
  if (vec) {
    const uint2 w = reinterpret_cast<const uint2*>(p)[i];
    a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
    b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  } else {
    p += 4 * i;
    a = __halves2bfloat162(p[0], p[1]);
    b = __halves2bfloat162(p[2], p[3]);
  }
  const float2 lo = __bfloat1622float2(a), hi = __bfloat1622float2(b);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_state(float* p, long long i, float4 v,
                                            bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(p)[i] = v;
    return;
  }
  p += 4 * i;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}

__device__ __forceinline__ void store_state(__nv_bfloat16* p, long long i,
                                            float4 v, bool vec) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  if (vec) {
    uint2 w;
    w.x = *reinterpret_cast<const unsigned*>(&a);
    w.y = *reinterpret_cast<const unsigned*>(&b);
    reinterpret_cast<uint2*>(p)[i] = w;
    return;
  }
  p += 4 * i;
  p[0] = a.x;
  p[1] = a.y;
  p[2] = b.x;
  p[3] = b.y;
}

__device__ __forceinline__ float state_one(float x) { return x; }
__device__ __forceinline__ float state_one(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void put_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Whether four elements of the state at p + 4i are one aligned vector.
__device__ __forceinline__ bool vec_ok(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __forceinline__ bool vec_ok(const __nv_bfloat16* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// one element: returns its code; un = uo + (q·s − c·so)·inv_n, in the plain
// version's order, each product and sum rounded (-fmad=false)
__device__ __forceinline__ float update_one(float x, int8_t c, float uo,
                                            float s, float so, float inv_n,
                                            float& un) {
  const float q = repro::quant(x, s);
  const float o = static_cast<float>(c) * so;
  un = uo + (q * s - o) * inv_n;
  return q;
}

// vector i of the row's aligned run: its four elements updated
template <typename U>
__device__ __forceinline__ void update_vec(int8_t* cv, U* ov, long long i,
                                           float4 x, char4 c, float4 uo,
                                           float s, float so, float inv_n,
                                           bool c4, bool o4) {
  float4 un;
  const char4 q = make_char4(
      static_cast<int8_t>(update_one(x.x, c.x, uo.x, s, so, inv_n, un.x)),
      static_cast<int8_t>(update_one(x.y, c.y, uo.y, s, so, inv_n, un.y)),
      static_cast<int8_t>(update_one(x.z, c.z, uo.z, s, so, inv_n, un.z)),
      static_cast<int8_t>(update_one(x.w, c.w, uo.w, s, so, inv_n, un.w)));
  if (c4) {
    reinterpret_cast<char4*>(cv)[i] = q;
  } else {
    int8_t* p = cv + 4 * i;
    p[0] = q.x;
    p[1] = q.y;
    p[2] = q.z;
    p[3] = q.w;
  }
  store_state(ov, i, un, o4);
}

// Grid: one cluster of C blocks, each thread holding kV vectors of g, their
// old codes and their u.
template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
    cache_update_kernel(const float* __restrict__ g, int8_t* data,
                        float* scale, const long long* __restrict__ row_index,
                        const U* __restrict__ u, U* __restrict__ u_out,
                        float inv_n, int n, long long d) {
  __shared__ repro::ClusterMax exchange;
  __shared__ float old_scale;
  repro::cg::cluster_group cluster = repro::cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());  // a power of two
  const int log2c = __ffs(C) - 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, T = blockDim.x;

  long long j = *row_index;
  j = j < 0 ? 0 : (j >= n ? n - 1 : j);
  int8_t* cr = data + j * d;
  const repro::RowSplit sp(g, d, rank, log2c, tid);
  const long long vlo = sp.vlo, vhi = sp.vhi, ej = sp.ej;
  const float4* gv = reinterpret_cast<const float4*>(g + sp.h);
  int8_t* cv = cr + sp.h;
  const U* uv = u + sp.h;
  U* ov = u_out + sp.h;
  const bool c4 = (reinterpret_cast<uintptr_t>(cv) & 3) == 0;
  const bool u4 = vec_ok(uv), o4 = vec_ok(ov);
  const float e = ej >= 0 ? g[ej] : 0.f;
  const int8_t ce = ej >= 0 ? cr[ej] : 0;
  const float ue = ej >= 0 ? state_one(u[ej]) : 0.f;
  exchange.start(C);
  // read before this block pushes its maximum (thread 0 arrives on rank 0)
  if (tid == 0) old_scale = scale[j];

  // pass 1: load the slice of g, its old codes and its u; take g's |max|
  float m = 0.f;
  float4 reg[kV], ureg[kV];
  char4 creg[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    reg[k] = i < vhi ? gv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    creg[k] = i < vhi ? load_codes(cv, i, c4) : make_char4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    ureg[k] = i < vhi ? load_state(uv, i, u4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k) m = repro::abs_max4(reg[k], m);

  const float s = repro::row_scale(
      exchange.combine(repro::nan_max(fabsf(e), m), C, rank));
  // every block has read scale[j]: its arrival on rank 0 came after
  if (rank == 0 && tid == 0) scale[j] = s;
  const float so = old_scale;

  // pass 2: codes and u'
  if (ej >= 0) {
    float un;
    cr[ej] = static_cast<int8_t>(update_one(e, ce, ue, s, so, inv_n, un));
    put_one(u_out + ej, un);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    if (i < vhi)
      update_vec(cv, ov, i, reg[k], creg[k], ureg[k], s, so, inv_n, c4, o4);
  }
}

// The same step on a cooperative grid that fills the card, for a row that
// no cluster keeps in registers (row_delta.cu's grid): pass 1 takes each
// block's |max| of g into partial[block], grid.sync() (which also orders
// every block's read of scale[j] before block 0 overwrites it), every block
// combines the G maxima, and pass 2 walks the row backwards (the end read
// last in pass 1 may still be in L2), reading g, the codes and u. Thread gt
// of the grid owns vectors gt + k·G·T.
constexpr int kGridThreads = 256;
constexpr int kGridScratch = 8192;    // floats of `partial`: most blocks

template <typename U>
__global__ void __launch_bounds__(kGridThreads)
    cache_update_grid_kernel(const float* __restrict__ g, int8_t* data,
                             float* scale,
                             const long long* __restrict__ row_index,
                             const U* __restrict__ u, U* __restrict__ u_out,
                             float inv_n, float* partial, int n,
                             long long d) {
  __shared__ float warp_part[kGridThreads / 32];
  __shared__ float old_scale, row_max;
  repro::cg::grid_group grid = repro::cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long G = gridDim.x;
  const long long stride = G * kGridThreads;
  const long long gt = static_cast<long long>(blockIdx.x) * kGridThreads +
                       tid;
  long long j = *row_index;
  j = j < 0 ? 0 : (j >= n ? n - 1 : j);
  int8_t* cr = data + j * d;
  const long long h = min(static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2), d);
  const long long nv = (d - h) >> 2;
  const int tail = static_cast<int>((d - h) & 3);
  const float4* gv = reinterpret_cast<const float4*>(g + h);
  int8_t* cv = cr + h;
  const U* uv = u + h;
  U* ov = u_out + h;
  const bool c4 = (reinterpret_cast<uintptr_t>(cv) & 3) == 0;
  const bool u4 = vec_ok(uv), o4 = vec_ok(ov);
  // the head on threads [0, h), the tail on [4, 4 + tail) of the grid
  const long long ej = gt < h ? gt
                              : (gt >= 4 && gt < 4 + tail ? h + 4 * nv + gt - 4
                                                          : -1);
  const float e = ej >= 0 ? g[ej] : 0.f;
  const int8_t ce = ej >= 0 ? cr[ej] : 0;
  const float ue = ej >= 0 ? state_one(u[ej]) : 0.f;
  if (tid == 0) old_scale = scale[j];

  float m = repro::nan_max(fabsf(e), 0.f);
  for (long long base = gt; base < nv; base += kUnroll * stride) {
    float4 a[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * stride;
      a[k] = i < nv ? gv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) m = repro::abs_max4(a[k], m);
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
    float r = 0.f;
    for (long long i = lane; i < G; i += 32)
      r = repro::nan_max(__ldcg(partial + i), r);
    r = repro::warp_max(r);
    if (lane == 0) row_max = r;
  }
  __syncthreads();
  const float s = repro::row_scale(row_max);
  if (blockIdx.x == 0 && tid == 0) scale[j] = s;
  const float so = old_scale;

  if (ej >= 0) {
    float un;
    cr[ej] = static_cast<int8_t>(update_one(e, ce, ue, s, so, inv_n, un));
    put_one(u_out + ej, un);
  }
  const long long span = kUnroll * stride;
  for (long long it = (nv + span - 1) / span - 1; it >= 0; --it) {
    const long long base = gt + it * span;
    float4 a[kUnroll], uo[kUnroll];
    char4 c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * stride;
      if (i < nv) {
        a[k] = gv[i];
        c[k] = load_codes(cv, i, c4);
        uo[k] = load_state(uv, i, u4);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * stride;
      if (i < nv)
        update_vec(cv, ov, i, a[k], c[k], uo[k], s, so, inv_n, c4, o4);
    }
  }
}

template <typename U>
cudaError_t launch_grid(const float* g, int8_t* data, float* scale,
                        const long long* row, const U* u, U* u_out,
                        float inv_n, float* partial, int n, long long d,
                        cudaStream_t stream) {
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cache_update_grid_kernel<U>, kGridThreads, 0);
    if (err != cudaSuccess) {
      per_sm = -1;
      return err;
    }
  }
  const unsigned blocks = static_cast<unsigned>(
      per_sm * sms < kGridScratch ? per_sm * sms : kGridScratch);
  void* args[] = {&g, &data, &scale, &row, &u, &u_out, &inv_n, &partial, &n,
                  &d};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cache_update_grid_kernel<U>), dim3(blocks),
      dim3(kGridThreads), args, 0, stream);
}

template <typename U>
cudaError_t launch(const float* g, int8_t* data, float* scale,
                   const long long* row, const void* u, void* u_out,
                   float inv_n, void* partial, int n, long long d,
                   int cluster, int threads, int per_thread, int on_chip,
                   cudaStream_t stream) {
  const U* ut = static_cast<const U*>(u);
  U* ot = static_cast<U*>(u_out);
  if (on_chip == kGrid) {
    if (partial == nullptr) return cudaErrorInvalidValue;
    return launch_grid<U>(g, data, scale, row, ut, ot, inv_n,
                          static_cast<float*>(partial), n, d, stream);
  }
  if (on_chip != kCluster ||
      !repro::row_plan_fits(d, cluster, threads, per_thread,
                            repro::kRegisters))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(cluster);
  if (per_thread != kV) return cudaErrorInvalidValue;
  return repro::launch_cluster(cache_update_kernel<U>, blocks, cluster,
                               threads, 0, stream, g, data, scale, row, ut,
                               ot, inv_n, n, d);
}

}  // namespace

// plan: `on_chip` 0 = one cluster of `cluster` blocks of `threads`,
// `per_thread` = 2 vectors a thread in registers (kernels/cache_update.py
// `_ace_plan`); 1 = the cooperative grid, which sizes itself and takes
// `partial` (kGridScratch floats). `bf16` selects a bfloat16 state (u and
// u'), else f32. A plan whose slices do not fit is refused
// (cudaErrorInvalidValue), never run.
REPRO_EXPORT int cache_row_update(const void* g, void* data, void* scale,
                                  const void* row, const void* u,
                                  void* u_out, float inv_n, void* partial,
                                  int n, long long d, int cluster,
                                  int threads, int per_thread, int on_chip,
                                  int bf16, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* gf = static_cast<const float*>(g);
  auto* ci = static_cast<int8_t*>(data);
  auto* sf = static_cast<float*>(scale);
  const auto* ri = static_cast<const long long*>(row);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(gf, ci, sf, ri, u, u_out, inv_n, partial,
                                   n, d, cluster, threads, per_thread,
                                   on_chip, st)
           : launch<float>(gf, ci, sf, ri, u, u_out, inv_n, partial, n, d,
                           cluster, threads, per_thread, on_chip, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
