// Shared pieces of the port's kernel libraries: the C export macro, the
// int8 quantizer of the rounding contract, and the error-string entry every
// library exposes next to its kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;

// q(g) = clip(rint(g / scale), -127, 127): IEEE division (no fast math) and
// round-half-to-even, like jnp.round / torch.round. Kept in f32.
__device__ __forceinline__ float quant(float g, float scale) {
  return fminf(fmaxf(rintf(g / scale), -127.f), 127.f);
}

inline unsigned blocks_for(long long d) {
  return static_cast<unsigned>((d + kThreads - 1) / kThreads);
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
