// Per-batch-seeded white noise, and the whitening damping fused with it.
//
// Replaces: psgd_torch_tpu/ops/pallas_kernels.py, _noise_kernel via
// unit_noise (TPU hardware PRNG, one row block per grid step), and the
// elementwise damping around it in psgd_torch_tpu/precond/kron.py
// _damped_stacked: g + (damping + eps(dtype)|g|) * v.
//
// Bound on the H100: the larger of bytes and instructions.  Unit mode
// writes the noise once; fused mode reads g once and writes the damped g
// once, so the noise v never goes through HBM (it is made in registers).
// Philox4x32-10 is not free: 20 IMAD.WIDE (half-rate pipe) and 20 LOP3 per
// four elements, plus the conversion, the damping and the packing.  In the
// SASS of the vector loop (python3 -m psgd_torch_tpu_torch.ops.sass LIB)
// that is 16.1 instructions per element in unit mode and 24.3 in fused
// mode in bf16 (15.6 and 21.0 in f32), 4.6 of them IMAD.WIDE; the earlier
// one-counter loop with scalar accesses issued 30.0 and 41.5.  On an H100
// (132 SMs, 4 warp-instructions per SM per clock, 1.98 GHz under load) the
// instructions of (22, 2048, 11264) bf16 take 0.24 ms (unit) and 0.37 ms
// (fused), under the bytes' 0.30 and 0.61 ms at 3.35 TB/s.
//
// Design.  A batch element whose length is a multiple of 8 (and whose
// arrays are 16-byte aligned) takes the vector kernel: each thread draws
// two consecutive Philox counters, which are 8 consecutive elements, so it
// loads g and stores the result as 16-byte vectors (one in bf16, two in
// f32); the load of g is issued before the rounds, so its latency hides
// under the integer work; the round keys are computed once per thread;
// indices are 32-bit within a batch element (psgd_noise refuses
// per_batch >= 2^31); the body has no bounds test; and the grid is the
// SMs times the blocks that fit on one, shared by the batch.  Any other
// length takes the scalar kernel (one counter, four scalar accesses with a
// bounds test), by shape: nothing is retried.  The stream is the same in
// both, so both give the bits of the plain version.  All float arithmetic
// uses explicit round-to-nearest intrinsics (no FMA contraction) so
// ops/kernels.py's plain PyTorch version reproduces the output bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxPerBatch = 1LL << 31;

// v = (float_in_1_2(word) - 1.5) * scale, and in fused mode
// g + (damping + eps|g|) * v with v rounded to T first.
template <typename T, bool kFused>
__device__ __forceinline__ float noise_value(uint32_t word, float gv, float scale,
                                             float damping, float eps) {
  const float v = __fmul_rn(__fsub_rn(psgd::float_in_1_2(word), 1.5f), scale);
  if (!kFused) return v;
  const float d = __fadd_rn(damping, __fmul_rn(eps, fabsf(gv)));
  return __fadd_rn(gv, __fmul_rn(d, psgd::stored<T>(v)));
}

// kOct: the vector kernel (per_batch % 8 == 0, 16-byte aligned arrays):
// thread m of a batch element takes counters 2m and 2m + 1, elements
// 8m ... 8m + 7.  Otherwise one counter, elements 4m ... 4m + 3.
template <typename T, bool kFused, bool kOct>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const T* __restrict__ g, T* __restrict__ out,
             const uint32_t* __restrict__ seeds, long long per_batch, float scale,
             float damping, float eps) {
  const int b = blockIdx.y;
  const psgd::PhiloxKey key = psgd::philox_key(seeds[2 * b], seeds[2 * b + 1]);
  const long long base = (long long)b * per_batch;
  T* o = out + base;
  const T* gb = kFused ? g + base : nullptr;
  if constexpr (kOct) {
    const uint32_t n_oct = (uint32_t)(per_batch / 8);
    for (uint32_t m = blockIdx.x * blockDim.x + threadIdx.x; m < n_oct;
         m += gridDim.x * blockDim.x) {
      float v[8];
      if (kFused) psgd::ldv<8>(gb + 8 * m, v);
      const uint4 w0 = psgd::philox4x32_10(2 * m, 0u, key);
      const uint4 w1 = psgd::philox4x32_10(2 * m + 1, 0u, key);
      const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v[t] = noise_value<T, kFused>(words[t], kFused ? v[t] : 0.f, scale, damping, eps);
      psgd::stv<8>(o + 8 * m, v);
    }
  } else {
    const long long n_ctr = (per_batch + 3) / 4;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n_ctr;
         m += (long long)gridDim.x * blockDim.x) {
      const uint4 w = psgd::philox4x32_10((uint32_t)m, (uint32_t)(m >> 32), key);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long e = 4 * m + t;
        if (e >= per_batch) break;
        const float gv = kFused ? psgd::ld(gb, e) : 0.f;
        psgd::st(o, e, noise_value<T, kFused>(words[t], gv, scale, damping, eps));
      }
    }
  }
}

// Blocks of x per batch element: enough to fill every SM once with as many
// blocks as fit on one, shared by the batch, and no more than the work.
template <typename T, bool kFused, bool kOct>
unsigned grid_x(int batch, long long threads_needed) {
  static int per_sm = 0;  // one value per instantiation (one card type)
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, noise_kernel<T, kFused, kOct>, kThreads, 0) != cudaSuccess)
    per_sm = 1;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long fill = ((long long)sms * per_sm + batch - 1) / batch;
  const long long need = (threads_needed + kThreads - 1) / kThreads;
  const long long blocks = need < fill ? need : fill;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename T, bool kFused, bool kOct>
void launch_mode(const T* g, T* out, const uint32_t* seeds, int batch, long long per_batch,
                 float scale, float damping, float eps, cudaStream_t stream) {
  const long long threads_needed = kOct ? per_batch / 8 : (per_batch + 3) / 4;
  const dim3 grid(grid_x<T, kFused, kOct>(batch, threads_needed), (unsigned)batch);
  noise_kernel<T, kFused, kOct><<<grid, kThreads, 0, stream>>>(g, out, seeds, per_batch,
                                                               scale, damping, eps);
}

template <typename T>
void launch(const void* g, void* out, const uint32_t* seeds, int batch,
            long long per_batch, int fused, float scale, float damping, float eps,
            cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const bool oct = per_batch % 8 == 0 && psgd::aligned16(g, out);
  if (fused && oct)
    launch_mode<T, true, true>(gt, ot, seeds, batch, per_batch, scale, damping, eps, stream);
  else if (fused)
    launch_mode<T, true, false>(gt, ot, seeds, batch, per_batch, scale, damping, eps, stream);
  else if (oct)
    launch_mode<T, false, true>(nullptr, ot, seeds, batch, per_batch, scale, damping, eps,
                                stream);
  else
    launch_mode<T, false, false>(nullptr, ot, seeds, batch, per_batch, scale, damping, eps,
                                 stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  fused = 0 writes the noise alone;
// fused = 1 writes g + (damping + eps|g|) * v.  per_batch < 2^31, else
// cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int psgd_noise(const void* g, void* out, const void* seeds, int batch,
                          long long per_batch, int dtype, int fused, float scale,
                          float damping, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  if (per_batch >= kMaxPerBatch) return (int)cudaErrorInvalidValue;
  if (batch > 0 && per_batch > 0) {
    if (dtype == 0)
      launch<float>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else
      launch<__nv_bfloat16>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
  }
  return (int)cudaGetLastError();
}
