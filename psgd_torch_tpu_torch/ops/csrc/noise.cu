// Per-batch-seeded white noise, and the whitening damping fused with it.
//
// Replaces: psgd_torch_tpu/ops/pallas_kernels.py, _noise_kernel via
// unit_noise (TPU hardware PRNG, one row block per grid step), and the
// elementwise damping around it in psgd_torch_tpu/precond/kron.py
// _damped_stacked: g + (damping + eps(dtype)|g|) * v.
//
// Bound on the H100: bytes only.  Unit mode writes the noise once; fused
// mode reads g once and writes the damped g once, so the noise v never goes
// through HBM (it is made in registers).  Philox4x32-10 costs ~40 integer
// ops per four elements, far below the card's integer rate at these bytes.
//
// Design: one thread per Philox call (four consecutive elements), a
// grid-stride loop over a batch element's counters, blockIdx.y = batch
// element.  All float arithmetic uses explicit round-to-nearest intrinsics
// (no FMA contraction) so ops/kernels.py's plain PyTorch version reproduces
// the output bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

template <typename T, bool kFused>
__global__ void noise_kernel(const T* __restrict__ g, T* __restrict__ out,
                             const uint32_t* __restrict__ seeds,
                             long long per_batch, float scale, float damping,
                             float eps) {
  const int b = blockIdx.y;
  const uint32_t k0 = seeds[2 * b], k1 = seeds[2 * b + 1];
  const long long n_ctr = (per_batch + 3) / 4;
  const long long base = (long long)b * per_batch;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n_ctr;
       m += (long long)gridDim.x * blockDim.x) {
    const uint4 w = psgd::philox4x32_10((uint32_t)m, (uint32_t)(m >> 32), k0, k1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long e = 4 * m + t;
      if (e >= per_batch) break;
      const float v = __fmul_rn(__fsub_rn(psgd::float_in_1_2(words[t]), 1.5f), scale);
      if (kFused) {
        const float vr = psgd::stored<T>(v);
        const float gv = psgd::ld(g, base + e);
        const float d = __fadd_rn(damping, __fmul_rn(eps, fabsf(gv)));
        psgd::st(out, base + e, __fadd_rn(gv, __fmul_rn(d, vr)));
      } else {
        psgd::st(out, base + e, v);
      }
    }
  }
}

template <typename T>
void launch(const void* g, void* out, const uint32_t* seeds, int batch,
            long long per_batch, int fused, float scale, float damping, float eps,
            cudaStream_t stream) {
  const int threads = 256;
  const long long n_ctr = (per_batch + 3) / 4;
  long long blocks = (n_ctr + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  if (fused)
    noise_kernel<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(out), seeds, per_batch, scale,
        damping, eps);
  else
    noise_kernel<T, false><<<grid, threads, 0, stream>>>(
        nullptr, static_cast<T*>(out), seeds, per_batch, scale, damping, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  fused = 0 writes the noise alone;
// fused = 1 writes g + (damping + eps|g|) * v.  Returns cudaGetLastError().
extern "C" int psgd_noise(const void* g, void* out, const void* seeds, int batch,
                          long long per_batch, int dtype, int fused, float scale,
                          float damping, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  if (batch > 0 && per_batch > 0) {
    if (dtype == 0)
      launch<float>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else
      launch<__nv_bfloat16>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
  }
  return (int)cudaGetLastError();
}
