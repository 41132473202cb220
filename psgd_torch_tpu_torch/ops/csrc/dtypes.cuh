// Loads and stores of the kernels' two storage types, float32 and bfloat16,
// through float: a bf16 value widens exactly, and a float rounds to the
// nearest bf16 (ties to even) once.  Shared by noise.cu and the NS kernels.
#pragma once
#include <cuda_bf16.h>

namespace psgd {

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// v as the nearest value of the storage type T.
template <typename T>
__device__ __forceinline__ float stored(float v) { return v; }
template <>
__device__ __forceinline__ float stored<__nv_bfloat16>(float v) { return bf16_round(v); }

}  // namespace psgd
