// Philox4x32-10 counter-based generator shared by the noise and NS kernels.
//
// Stream layout (identical in ops/philox.py, the plain PyTorch version):
// key = the two 32-bit seed words of one batch element; the 64-bit counter
// is element_offset / 4 (low word first, the other two counter words 0);
// element e takes output word e % 4.  A stream is therefore a pure function
// of its seed words, whatever the batch size or launch shape.
#pragma once
#include <stdint.h>

namespace psgd {

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
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
