// Philox4x32-10 counter-based generator shared by the noise and NS kernels.
//
// Stream layout (identical in ops/philox.py, the plain PyTorch version):
// key = the two 32-bit seed words of one batch element; the 64-bit counter
// is element_offset / 4 (low word first, the other two counter words 0);
// element e takes output word e % 4.  A stream is therefore a pure function
// of its seed words, whatever the batch size or launch shape.
//
// A round is two 32 x 32 -> 64-bit products (one IMAD.WIDE.U32 each, both
// halves at once) and two three-input xors.  The ten round keys depend on
// the seed words alone, so a kernel that draws many counters of one stream
// computes them once (PhiloxKey) instead of two adds per round and call.
#pragma once
#include <stdint.h>

namespace psgd {

struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t k0, uint32_t k1) {
  PhiloxKey key;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    key.k0[r] = k0 + (uint32_t)r * 0x9E3779B9u;
    key.k1[r] = k1 + (uint32_t)r * 0xBB67AE85u;
  }
  return key;
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               const PhiloxKey& key) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = (unsigned long long)c0 * 0xD2511F53u;
    const unsigned long long p1 = (unsigned long long)c2 * 0xCD9E8D57u;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ key.k0[r];
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ key.k1[r];
    c0 = n0;
    c1 = (uint32_t)p1;
    c2 = n2;
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  return philox4x32_10(c0, c1, philox_key(k0, k1));
}

// One 32-bit word of the stream: element e of the stream keyed (k0, k1).
__device__ __forceinline__ uint32_t philox_word(uint32_t k0, uint32_t k1,
                                                long long e) {
  const unsigned long long m = (unsigned long long)e >> 2;
  const uint4 w = philox4x32_10((uint32_t)m, (uint32_t)(m >> 32), k0, k1);
  const int t = (int)(e & 3);
  return t == 0 ? w.x : t == 1 ? w.y : t == 2 ? w.z : w.w;
}

// Mantissa trick: 23 random bits under exponent 0 give a float in [1, 2).
__device__ __forceinline__ float float_in_1_2(uint32_t bits) {
  return __uint_as_float((bits & 0x7FFFFFu) | 0x3F800000u);
}

}  // namespace psgd
