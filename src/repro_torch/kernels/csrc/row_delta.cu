// The whole int8 cache-row swap of the incremental running-sum rules (ACED's
// active-set sum, CA²FL's calibration sum), K = 1 arrival per tick, in one
// launch: for the cache (data (n, d) int8, scale (n,) f32), the row index j
// (a device int64) and the payload g (d,) f32,
//     s     = max(max|g|, 1e-12) / 127                      (new scale)
//     old   = data[j]·scale[j]                              (f32)
//     delta = q(g)·s − old                                  (f32)
//     data[j] = q(g),  scale[j] = s                         (in place)
//
// Replaces the TPU kernel src/repro/kernels/row_delta.py::row_delta
// (pallas_call at row_delta.py:66), whose function (delta and c' given both
// scales) keeps its plain version, kernels/ref.row_delta_ref; on the TPU the
// scale, the gather and the scatter around it fused into the one jitted
// program of FlatCache.set_row_delta. Here the plain version of the whole
// call is kernels/ref.set_row_delta_ref, eight or more PyTorch kernels.
//
// Bound on an H100: memory. Per feature it reads g (4 B) and the old code
// (1 B) and writes the new code (1 B), delta and old (4 B each): 14 B. At the
// vision task's d = 17,226 that is 241 KB, about 72 ns at 3.35 TB/s, far
// below the launch latency: the call is latency-bound, and what counts is
// one launch in place of a chain, how many SMs share the row and how few
// dependent steps each takes.
//
// Design: quantize_rows' (quant.cu) for one row, with the row gathered by
// index: the row spread over a thread-block cluster and its |max| agreed
// through distributed shared memory (cluster_row.cuh), the plan from
// kernels/row_delta.py `_row_plan`, quantize_rows' for one row. A block
// loads its slice of g and its old codes into registers, every load issued
// before the first use. Thread 0 of each block reads scale[j] before the
// block pushes its maximum; rank 0 overwrites it only once its wait has
// seen all C arrivals, each a release at cluster scope after that read, so
// no block reads the new scale as the old one. Each code of the row is read
// and written by the same thread. A row too long for 4 vectors a thread
// (8 would spill under the 1024-thread bound, 64 registers a thread) goes
// to a cooperative grid over the whole card instead (below): at
// d = 2^24 + 3 that took 0.123 ms, where one cluster streaming the row
// twice through its 8 SMs took over four times as long and the unfused
// call 0.367 ms (tools/agg_swap_designs.py; NVIDIA H100 80GB HBM3,
// 700.00 W). The f32 outputs are stored as float4 where
// they share g's 16-byte phase (fresh allocations beside an aligned g), else
// one at a time; the codes as char4 where the row's codes are 4-byte aligned
// there, else byte by byte. A j outside [0, n) is clamped, as JAX's
// dynamic_index_in_dim clamps.
#include "cluster_row.cuh"

namespace {

using repro::kMaxThreads;
using repro::kUnroll;
using repro::load_codes;
enum Place { kCluster = 0, kGrid = 1 };

// one element: returns its code; old = c·so, dl = q·s − old
__device__ __forceinline__ float swap_one(float x, int8_t c, float s,
                                          float so, float& dl, float& o) {
  const float q = repro::quant(x, s);
  o = static_cast<float>(c) * so;
  dl = q * s - o;
  return q;
}

// vector i of the row's aligned run: its four elements swapped
__device__ __forceinline__ void swap_vec(int8_t* cv, float* dv, float* ov,
                                         long long i, float4 x, char4 c,
                                         float s, float so, bool c4,
                                         bool f4) {
  float4 dl, o;
  const char4 q = make_char4(
      static_cast<int8_t>(swap_one(x.x, c.x, s, so, dl.x, o.x)),
      static_cast<int8_t>(swap_one(x.y, c.y, s, so, dl.y, o.y)),
      static_cast<int8_t>(swap_one(x.z, c.z, s, so, dl.z, o.z)),
      static_cast<int8_t>(swap_one(x.w, c.w, s, so, dl.w, o.w)));
  if (c4) {
    reinterpret_cast<char4*>(cv)[i] = q;
  } else {
    int8_t* p = cv + 4 * i;
    p[0] = q.x;
    p[1] = q.y;
    p[2] = q.z;
    p[3] = q.w;
  }
  if (f4) {
    reinterpret_cast<float4*>(dv)[i] = dl;
    reinterpret_cast<float4*>(ov)[i] = o;
  } else {
    float* pd = dv + 4 * i;
    float* po = ov + 4 * i;
    pd[0] = dl.x;
    pd[1] = dl.y;
    pd[2] = dl.z;
    pd[3] = dl.w;
    po[0] = o.x;
    po[1] = o.y;
    po[2] = o.z;
    po[3] = o.w;
  }
}

// Grid: one cluster of C blocks, each thread holding V vectors of g and
// their old codes.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    row_delta_kernel(const float* __restrict__ g, int8_t* data, float* scale,
                     const long long* __restrict__ row_index,
                     float* __restrict__ delta, float* __restrict__ old,
                     int n, long long d) {
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
  float* dv = delta + sp.h;
  float* ov = old + sp.h;
  const bool c4 = (reinterpret_cast<uintptr_t>(cv) & 3) == 0;
  const bool f4 = ((reinterpret_cast<uintptr_t>(dv) |
                    reinterpret_cast<uintptr_t>(ov)) & 15) == 0;
  const float e = ej >= 0 ? g[ej] : 0.f;
  const int8_t ce = ej >= 0 ? cr[ej] : 0;
  exchange.start(C);
  // read before this block pushes its maximum (thread 0 arrives on rank 0)
  if (tid == 0) old_scale = scale[j];

  // pass 1: load the slice of g and its old codes, and take its |max|
  float m = 0.f;
  float4 reg[V];
  char4 creg[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    reg[k] = i < vhi ? gv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    creg[k] = i < vhi ? load_codes(cv, i, c4) : make_char4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) m = repro::abs_max4(reg[k], m);

  const float s = repro::row_scale(
      exchange.combine(repro::nan_max(fabsf(e), m), C, rank));
  // every block has read scale[j]: its arrival on rank 0 came after
  if (rank == 0 && tid == 0) scale[j] = s;
  const float so = old_scale;

  // pass 2: codes, delta and old
  if (ej >= 0) {
    float dl, o;
    cr[ej] = static_cast<int8_t>(swap_one(e, ce, s, so, dl, o));
    delta[ej] = dl;
    old[ej] = o;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long i = vlo + tid + static_cast<long long>(k) * T;
    if (i < vhi) swap_vec(cv, dv, ov, i, reg[k], creg[k], s, so, c4, f4);
  }
}

// The same swap on a cooperative grid that fills the card, for a row that
// no cluster keeps in registers: pass 1 takes each block's |max| into
// partial[block], grid.sync() (which also orders every block's read of
// scale[j] before block 0 overwrites it), every block combines the G
// maxima, and pass 2 walks the row backwards (the end read last in pass 1
// may still be in L2). Thread gt of the grid owns vectors gt + k·G·T.
constexpr int kGridThreads = 256;
constexpr int kGridScratch = 8192;    // floats of `partial`: most blocks

__global__ void __launch_bounds__(kGridThreads)
    row_delta_grid_kernel(const float* __restrict__ g, int8_t* data,
                          float* scale,
                          const long long* __restrict__ row_index,
                          float* __restrict__ delta, float* __restrict__ old,
                          float* partial, int n, long long d) {
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
  float* dv = delta + h;
  float* ov = old + h;
  const bool c4 = (reinterpret_cast<uintptr_t>(cv) & 3) == 0;
  const bool f4 = ((reinterpret_cast<uintptr_t>(dv) |
                    reinterpret_cast<uintptr_t>(ov)) & 15) == 0;
  // the head on threads [0, h), the tail on [4, 4 + tail) of the grid
  const long long ej = gt < h ? gt
                              : (gt >= 4 && gt < 4 + tail ? h + 4 * nv + gt - 4
                                                          : -1);
  const float e = ej >= 0 ? g[ej] : 0.f;
  const int8_t ce = ej >= 0 ? cr[ej] : 0;
  if (tid == 0) old_scale = scale[j];

  float m = repro::nan_max(fabsf(e), 0.f);
  for (long long base = gt; base < nv; base += kUnroll * stride) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      a[u] = i < nv ? gv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = repro::abs_max4(a[u], m);
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
    float dl, o;
    cr[ej] = static_cast<int8_t>(swap_one(e, ce, s, so, dl, o));
    delta[ej] = dl;
    old[ej] = o;
  }
  const long long span = kUnroll * stride;
  for (long long it = (nv + span - 1) / span - 1; it >= 0; --it) {
    const long long base = gt + it * span;
    float4 a[kUnroll];
    char4 c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < nv) {
        a[u] = gv[i];
        c[u] = load_codes(cv, i, c4);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < nv) swap_vec(cv, dv, ov, i, a[u], c[u], s, so, c4, f4);
    }
  }
}

cudaError_t launch_grid(const float* g, int8_t* data, float* scale,
                        const long long* row, float* delta, float* old,
                        float* partial, int n, long long d,
                        cudaStream_t stream) {
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_delta_grid_kernel, kGridThreads, 0);
    if (err != cudaSuccess) {
      per_sm = -1;
      return err;
    }
  }
  const unsigned blocks = static_cast<unsigned>(
      per_sm * sms < kGridScratch ? per_sm * sms : kGridScratch);
  void* args[] = {&g, &data, &scale, &row, &delta, &old, &partial, &n, &d};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(row_delta_grid_kernel), dim3(blocks),
      dim3(kGridThreads), args, 0, stream);
}

template <int V>
cudaError_t launch_on_cluster(const float* g, int8_t* data, float* scale,
                              const long long* row, float* delta, float* old,
                              int n, long long d, int cluster, int threads,
                              cudaStream_t stream) {
  return repro::launch_cluster(row_delta_kernel<V>,
                               static_cast<unsigned>(cluster), cluster,
                               threads, 0, stream, g, data, scale, row, delta,
                               old, n, d);
}

}  // namespace

// plan: `on_chip` 0 = one cluster of `cluster` blocks of `threads`,
// `per_thread` (2 or 4) vectors a thread in registers, as quantize_rows'
// registers plan for one row; 1 = the cooperative grid, which sizes itself
// and takes `partial` (kGridScratch floats). A plan whose slices do not fit
// is refused (cudaErrorInvalidValue), never run.
REPRO_EXPORT int row_delta(const void* g, void* data, void* scale,
                           const void* row, void* delta, void* old,
                           void* partial, int n, long long d, int cluster,
                           int threads, int per_thread, int on_chip,
                           void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* gf = static_cast<const float*>(g);
  auto* ci = static_cast<int8_t*>(data);
  auto* sf = static_cast<float*>(scale);
  const auto* ri = static_cast<const long long*>(row);
  auto* df = static_cast<float*>(delta);
  auto* of = static_cast<float*>(old);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (on_chip == kGrid) {
    if (partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_grid(gf, ci, sf, ri, df, of, static_cast<float*>(partial), n,
                      d, st);
  } else if (on_chip != kCluster ||
             !repro::row_plan_fits(d, cluster, threads, per_thread,
                                   repro::kRegisters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (per_thread == 2) {
    err = launch_on_cluster<2>(gf, ci, sf, ri, df, of, n, d, cluster,
                               threads, st);
  } else if (per_thread == 4) {
    err = launch_on_cluster<4>(gf, ci, sf, ri, df, of, n, d, cluster,
                               threads, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
