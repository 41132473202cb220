// Loads and stores of the kernels' storage types, float32 and bfloat16,
// through float: a bf16 value widens exactly, and a float rounds to the
// nearest bf16 (ties to even) once.  Shared by noise.cu and the NS kernels.
// float64 (the noise kernel's double instantiation) moves as double.
//
// ldv<V> / stv<V> move V consecutive elements as one access (V = 1) or as
// vectors: float4s of f32, double2s of f64, 16-byte vectors of bf16 (and
// 8-byte ones for stv<4>, the bf16 copy of four f32); the caller
// guarantees the alignment.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace psgd {

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ double ld(const double* p, long long i) { return p[i]; }
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(double* p, long long i, double v) { p[i] = v; }
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

// two bf16 in one 32-bit word, element 0 in the low half
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t w;
  memcpy(&w, &h, 4);
  return w;
}

template <int V>
__device__ __forceinline__ void ldv(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
    static_assert(V % 4 == 0, "float vectors are float4");
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(p[0]);
  } else {
    static_assert(V % 8 == 0, "bf16 vectors are 8 or 16 bytes");
#pragma unroll
    for (int i = 0; i < V; i += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + i);
      unpack_bf16x2(x.x, v + i);
      unpack_bf16x2(x.y, v + i + 2);
      unpack_bf16x2(x.z, v + i + 4);
      unpack_bf16x2(x.w, v + i + 6);
    }
  }
}

template <int V>
__device__ __forceinline__ void ldv(const double* p, double* v) {
  static_assert(V % 2 == 0, "double vectors are double2");
#pragma unroll
  for (int i = 0; i < V; i += 2) {
    const double2 x = *reinterpret_cast<const double2*>(p + i);
    v[i] = x.x, v[i + 1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void stv(double* p, const double* v) {
  static_assert(V % 2 == 0, "double vectors are double2");
#pragma unroll
  for (int i = 0; i < V; i += 2)
    *reinterpret_cast<double2*>(p + i) = make_double2(v[i], v[i + 1]);
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    static_assert(V % 4 == 0, "float vectors are float4");
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int V>
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    static_assert(V % 8 == 0, "bf16 vectors are 8 or 16 bytes");
#pragma unroll
    for (int i = 0; i < V; i += 8)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(pack_bf16x2(v[i], v[i + 1]), pack_bf16x2(v[i + 2], v[i + 3]),
                     pack_bf16x2(v[i + 4], v[i + 5]), pack_bf16x2(v[i + 6], v[i + 7]));
  }
}

// Whether every pointer given is 16-byte aligned (null counts as aligned).
__host__ __device__ inline bool aligned16(const void* a, const void* b = nullptr,
                                          const void* c = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

}  // namespace psgd
