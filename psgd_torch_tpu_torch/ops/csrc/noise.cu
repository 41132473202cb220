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
//
// float64 and the complex mode.  The uniform is always the float32 value
// (f - 1.5) * scale of the word; a float64 output (the double
// instantiation of noise_kernel) is that float widened, and its damping is
// computed in double.  A complex element (complex64 as float pairs,
// complex128 as double pairs, interleaved (re, im) as torch.view_as_real
// lays them out) takes its real part from the stream of the batch
// element's first two seed words and its imaginary part from the stream of
// its last two, at the element's own counter, each part the uniform times
// 2^-0.5 in the part's type (noise_complex_kernel): the JAX package's
// (u(kr) s + 1j u(ki) s) with (kr, ki) = split(key).  Fused, it writes
// g + (damping + eps hypot(re g, im g)) v per part.  One thread takes one
// counter of both streams, four complex elements: as 16-byte vectors where
// the length is a multiple of 4 and the arrays are aligned, else one part
// at a time with a bounds test.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxPerBatch = 1LL << 31;

// The arithmetic type of a storage type: float for float and bf16, double
// for double.
template <typename T> struct Compute { using type = float; };
template <> struct Compute<double> { using type = double; };
template <typename T> using compute_t = typename Compute<T>::type;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float hypot_rn(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hypot_rn(double a, double b) { return hypot(a, b); }

// The float32 uniform (float_in_1_2(word) - 1.5) * scale.
__device__ __forceinline__ float unit_value(uint32_t word, float scale) {
  return __fmul_rn(__fsub_rn(psgd::float_in_1_2(word), 1.5f), scale);
}

// v = the uniform, and in fused mode g + (damping + eps|g|) * v with v
// rounded to T first, in T's arithmetic type.
template <typename T, bool kFused>
__device__ __forceinline__ compute_t<T> noise_value(uint32_t word, compute_t<T> gv,
                                                    float scale, compute_t<T> damping,
                                                    compute_t<T> eps) {
  using C = compute_t<T>;
  const float v = unit_value(word, scale);
  if (!kFused) return v;
  const C d = add_rn(damping, mul_rn(eps, (C)fabs(gv)));
  return add_rn(gv, mul_rn(d, (C)psgd::stored<T>(v)));
}

// kOct: the vector kernel (per_batch % 8 == 0, 16-byte aligned arrays):
// thread m of a batch element takes counters 2m and 2m + 1, elements
// 8m ... 8m + 7.  Otherwise one counter, elements 4m ... 4m + 3.
template <typename T, bool kFused, bool kOct>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const T* __restrict__ g, T* __restrict__ out,
             const uint32_t* __restrict__ seeds, long long per_batch, float scale,
             compute_t<T> damping, compute_t<T> eps) {
  using C = compute_t<T>;
  const int b = blockIdx.y;
  const psgd::PhiloxKey key = psgd::philox_key(seeds[2 * b], seeds[2 * b + 1]);
  const long long base = (long long)b * per_batch;
  T* o = out + base;
  const T* gb = kFused ? g + base : nullptr;
  if constexpr (kOct) {
    const uint32_t n_oct = (uint32_t)(per_batch / 8);
    for (uint32_t m = blockIdx.x * blockDim.x + threadIdx.x; m < n_oct;
         m += gridDim.x * blockDim.x) {
      C v[8];
      if (kFused) psgd::ldv<8>(gb + 8 * m, v);
      const uint4 w0 = psgd::philox4x32_10(2 * m, 0u, key);
      const uint4 w1 = psgd::philox4x32_10(2 * m + 1, 0u, key);
      const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v[t] = noise_value<T, kFused>(words[t], kFused ? v[t] : C(0), scale, damping, eps);
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
        const C gv = kFused ? psgd::ld(gb, e) : C(0);
        psgd::st(o, e, noise_value<T, kFused>(words[t], gv, scale, damping, eps));
      }
    }
  }
}

// One part of a complex element: the uniform times 2^-0.5 in T, and in
// fused mode the damped part gv + d * that.
template <typename T, bool kFused>
__device__ __forceinline__ T complex_part(uint32_t word, T gv, T d, float scale, T part) {
  const T v = mul_rn((T)unit_value(word, scale), part);
  return kFused ? add_rn(gv, mul_rn(d, v)) : v;
}

// The complex mode: T = float (complex64) or double (complex128), per_batch
// complex elements of 2 T each; batch element b's seeds are words 4b ...
// 4b + 3, the real part's stream keyed by the first two, the imaginary
// part's by the last two.  kVec (per_batch % 4 == 0, 16-byte aligned
// arrays): the 8 parts of a thread's 4 elements move as vectors.
template <typename T, bool kFused, bool kVec>
__global__ void __launch_bounds__(kThreads)
noise_complex_kernel(const T* __restrict__ g, T* __restrict__ out,
                     const uint32_t* __restrict__ seeds, long long per_batch,
                     float scale, T part, T damping, T eps) {
  const int b = blockIdx.y;
  const psgd::PhiloxKey kr = psgd::philox_key(seeds[4 * b], seeds[4 * b + 1]);
  const psgd::PhiloxKey ki = psgd::philox_key(seeds[4 * b + 2], seeds[4 * b + 3]);
  const long long base = 2 * (long long)b * per_batch;
  T* o = out + base;
  const T* gb = kFused ? g + base : nullptr;
  const long long n_ctr = (per_batch + 3) / 4;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n_ctr;
       m += (long long)gridDim.x * blockDim.x) {
    const uint4 r = psgd::philox4x32_10((uint32_t)m, (uint32_t)(m >> 32), kr);
    const uint4 i = psgd::philox4x32_10((uint32_t)m, (uint32_t)(m >> 32), ki);
    const uint32_t words[8] = {r.x, i.x, r.y, i.y, r.z, i.z, r.w, i.w};
    if constexpr (kVec) {
      T v[8];
      if (kFused) psgd::ldv<8>(gb + 8 * m, v);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        const T d = kFused ? add_rn(damping, mul_rn(eps, hypot_rn(v[t], v[t + 1]))) : T(0);
        v[t] = complex_part<T, kFused>(words[t], kFused ? v[t] : T(0), d, scale, part);
        v[t + 1] = complex_part<T, kFused>(words[t + 1], kFused ? v[t + 1] : T(0), d,
                                           scale, part);
      }
      psgd::stv<8>(o + 8 * m, v);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long e = 4 * m + t;
        if (e >= per_batch) break;
        const T gr = kFused ? gb[2 * e] : T(0), gi = kFused ? gb[2 * e + 1] : T(0);
        const T d = kFused ? add_rn(damping, mul_rn(eps, hypot_rn(gr, gi))) : T(0);
        o[2 * e] = complex_part<T, kFused>(words[2 * t], gr, d, scale, part);
        o[2 * e + 1] = complex_part<T, kFused>(words[2 * t + 1], gi, d, scale, part);
      }
    }
  }
}

// Blocks of x per batch element: enough to fill every SM once with as many
// blocks as fit on one, shared by the batch, and no more than the work.
template <auto kKernel>
unsigned grid_x(int batch, long long threads_needed) {
  static int per_sm = 0;  // one value per kernel (one card type)
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, kKernel, kThreads, 0) != cudaSuccess)
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
                 float scale, double damping, double eps, cudaStream_t stream) {
  const long long threads_needed = kOct ? per_batch / 8 : (per_batch + 3) / 4;
  constexpr auto kernel = noise_kernel<T, kFused, kOct>;
  const dim3 grid(grid_x<kernel>(batch, threads_needed), (unsigned)batch);
  kernel<<<grid, kThreads, 0, stream>>>(g, out, seeds, per_batch, scale,
                                        (compute_t<T>)damping, (compute_t<T>)eps);
}

template <typename T>
void launch(const void* g, void* out, const uint32_t* seeds, int batch,
            long long per_batch, int fused, float scale, double damping, double eps,
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

template <typename T, bool kFused, bool kVec>
void launch_complex_mode(const T* g, T* out, const uint32_t* seeds, int batch,
                         long long per_batch, float scale, double damping, double eps,
                         cudaStream_t stream) {
  constexpr auto kernel = noise_complex_kernel<T, kFused, kVec>;
  const dim3 grid(grid_x<kernel>(batch, (per_batch + 3) / 4), (unsigned)batch);
  // 2^-0.5 rounded to T, as the plain version's constant
  kernel<<<grid, kThreads, 0, stream>>>(g, out, seeds, per_batch, scale,
                                        (T)0.70710678118654752440, (T)damping, (T)eps);
}

template <typename T>
void launch_complex(const void* g, void* out, const uint32_t* seeds, int batch,
                    long long per_batch, int fused, float scale, double damping,
                    double eps, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const bool vec = per_batch % 4 == 0 && psgd::aligned16(g, out);
  if (fused && vec)
    launch_complex_mode<T, true, true>(gt, ot, seeds, batch, per_batch, scale, damping,
                                       eps, stream);
  else if (fused)
    launch_complex_mode<T, true, false>(gt, ot, seeds, batch, per_batch, scale, damping,
                                        eps, stream);
  else if (vec)
    launch_complex_mode<T, false, true>(nullptr, ot, seeds, batch, per_batch, scale,
                                        damping, eps, stream);
  else
    launch_complex_mode<T, false, false>(nullptr, ot, seeds, batch, per_batch, scale,
                                         damping, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64 (two seed words per batch
// element), 3 = complex64, 4 = complex128 (four seed words per batch
// element; per_batch counts complex elements).  fused = 0 writes the
// noise alone; fused = 1 writes g + (damping + eps|g|) * v, damping and
// eps rounded to the arithmetic type.  per_batch < 2^31, else
// cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int psgd_noise(const void* g, void* out, const void* seeds, int batch,
                          long long per_batch, int dtype, int fused, float scale,
                          double damping, double eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  if (per_batch >= kMaxPerBatch || dtype < 0 || dtype > 4) return (int)cudaErrorInvalidValue;
  if (batch > 0 && per_batch > 0) {
    if (dtype == 0)
      launch<float>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else if (dtype == 1)
      launch<__nv_bfloat16>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else if (dtype == 2)
      launch<double>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else if (dtype == 3)
      launch_complex<float>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
    else
      launch_complex<double>(g, out, sd, batch, per_batch, fused, scale, damping, eps, s);
  }
  return (int)cudaGetLastError();
}
