// Fused int8 cache-row swap for the incremental running-sum rules (ACED's
// active-set sum, CA²FL's calibration sum), K = 1 arrival per tick:
//     delta  = q(g)·new_scale − c·old_scale      (f32)
//     c'     = q(g)                              (int8)
//
// Replaces the TPU kernel src/repro/kernels/row_delta.py::row_delta
// (pallas_call at row_delta.py:66), called from FlatCache.set_row_delta.
//
// Bound on an H100: memory. Per feature it reads g (4 B) and c (1 B) and
// writes delta (4 B) and c' (1 B): 10 B and 4 flops. At the vision task's
// d = 17,226 that is 172 KB, about 51 ns at 3.35 TB/s — far below the
// launch latency, so on the engine's path the kernel is launch-bound.
// Design: one thread per feature over a 1-D grid on d, ragged tail masked,
// coalesced loads; the two scales are read through device pointers (they
// come out of the cache and out of row_scale on the card, and passing them
// by value would need a host sync every tick).
#include "common.cuh"

namespace {

__global__ void row_delta_kernel(const float* __restrict__ g,
                                 const int8_t* __restrict__ c,
                                 const float* __restrict__ old_scale,
                                 const float* __restrict__ new_scale,
                                 float* __restrict__ delta,
                                 int8_t* __restrict__ c_out, long long d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= d) return;
  const float s_old = *old_scale;
  const float s_new = *new_scale;
  const float old = static_cast<float>(c[i]) * s_old;
  const float q = repro::quant(g[i], s_new);
  delta[i] = q * s_new - old;
  c_out[i] = static_cast<int8_t>(q);
}

}  // namespace

REPRO_EXPORT int row_delta(const void* g, const void* c, const void* old_scale,
                           const void* new_scale, void* delta, void* c_out,
                           long long d, void* stream) {
  if (d > 0) {
    row_delta_kernel<<<repro::blocks_for(d), repro::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const int8_t*>(c),
        static_cast<const float*>(old_scale),
        static_cast<const float*>(new_scale), static_cast<float*>(delta),
        static_cast<int8_t*>(c_out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
