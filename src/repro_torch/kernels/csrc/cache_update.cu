// Fused ACE incremental cache-row update (paper Alg. a.5 with the App.
// F.3.3 int8 cache), K = 1 arrival per tick:
//     u' = u + (q(g)·new_scale − c·old_scale)·inv_n     (f32)
//     c' = q(g)                                         (int8)
//
// Replaces the TPU kernel src/repro/kernels/cache_update.py::cache_row_update
// (pallas_call at cache_update.py:67), called from ACEIncremental.step.
//
// Bound on an H100: memory. Per feature it reads u and g (4 B each) and c
// (1 B) and writes u' (4 B) and c' (1 B): 14 B and 6 flops. At the vision
// task's d = 17,226 that is 241 KB, about 72 ns at 3.35 TB/s — far below
// the launch latency, so on the engine's path the kernel is launch-bound.
// Design: one thread per feature over a 1-D grid on d, ragged tail masked,
// coalesced loads; the three scalars are read through device pointers so
// the caller never syncs with the host.
#include "common.cuh"

namespace {

__global__ void cache_update_kernel(const float* __restrict__ u,
                                    const float* __restrict__ g,
                                    const int8_t* __restrict__ c,
                                    const float* __restrict__ old_scale,
                                    const float* __restrict__ new_scale,
                                    const float* __restrict__ inv_n,
                                    float* __restrict__ u_out,
                                    int8_t* __restrict__ c_out, long long d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= d) return;
  const float s_old = *old_scale;
  const float s_new = *new_scale;
  const float old = static_cast<float>(c[i]) * s_old;
  const float q = repro::quant(g[i], s_new);
  u_out[i] = u[i] + (q * s_new - old) * *inv_n;
  c_out[i] = static_cast<int8_t>(q);
}

}  // namespace

REPRO_EXPORT int cache_row_update(const void* u, const void* g, const void* c,
                                  const void* old_scale, const void* new_scale,
                                  const void* inv_n, void* u_out, void* c_out,
                                  long long d, void* stream) {
  if (d > 0) {
    cache_update_kernel<<<repro::blocks_for(d), repro::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(g),
        static_cast<const int8_t*>(c), static_cast<const float*>(old_scale),
        static_cast<const float*>(new_scale),
        static_cast<const float*>(inv_n), static_cast<float*>(u_out),
        static_cast<int8_t*>(c_out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
