// Shared pieces of the port's kernel libraries: the C export macro, the
// int8 quantizer of the rounding contract, and the error-string entry every
// library exposes next to its kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// q(g) = clip(rint(g / scale), -127, 127): IEEE division (no fast math) and
// round-half-to-even, like jnp.round / torch.round. Kept in f32. A NaN
// quotient (a NaN element or scale, or ±inf/inf in a row whose scale is
// inf) gives 0, the code XLA's and PyTorch's float→int8 conversions give
// it; fmaxf alone would drop the NaN and clip it to -127.
__device__ __forceinline__ float quant(float g, float scale) {
  const float r = g / scale;
  return r != r ? 0.f : fminf(fmaxf(rintf(r), -127.f), 127.f);
}

// quant(g, scale) with one multiply in place of the division, where that
// gives the same bits. inv = RN(1/scale), by IEEE division, once per scale,
// or NaN where that is not finite (a scale below 2^-128: every element then
// divides). q0 = RN(g·inv) lies within 2^-23·|g/scale| of g/scale for a
// normal inv (a subnormal one, scale > 2^126, leaves |g/scale| < 4 and the
// error below 2e-6), so within 2.3e-5 of RN(g/scale) while |q0| < 129.
// Where q0 is farther than 1e-4 from every half-integer, then,
// rint(q0) = rint(RN(g/scale)); where |q0| ≥ 129 both clip to ±127:
// q = clip(rint(q0)) and the result is true. Near a tie, and for a NaN q0,
// it returns false and the caller divides.
__device__ __forceinline__ bool quant_fast(float g, float inv, float& q) {
  const float q0 = g * inv;
  const float n = rintf(q0);
  q = fminf(fmaxf(n, -127.f), 127.f);
  // |q0 − n| is exact below 129; 0.5 − |q0 − n| is the distance to a tie
  return fabsf(q0) >= 129.f || fabsf(q0 - n) < 0.5f - 1e-4f;
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
