// The tiled Newton-Schulz route: the five pieces of _tiled_ns_update, each
// its own C entry point, with every (n, n) intermediate stored in Q's dtype.
//
// Replaces: psgd_torch_tpu/ops/pallas_kernels.py
//   _tiled_bound_kernel   (via _tiled_bound)  -> psgd_norm_bound
//   _tiled_step_kernel                        -> psgd_tiled_step
//   _tiled_tsub_kernel                        -> psgd_tsub
//   _tiled_smm_kernel                         -> psgd_scaled_matmul_trace
//   _tiled_combine_kernel                     -> psgd_tiled_combine
// On the TPU these stream row blocks of a matrix against another held
// whole in VMEM.  Here each product is a GEMM over shared-memory tiles; the
// scalar glue between the pieces (L', lr/L', 1/|R|, the step a) is a few
// PyTorch ops on (B,) device tensors, so nothing waits on the host.
//
// Bounds on the H100: the bound, the step and the two scaled products are
// bound by operations (2 k n^2 per thin product, 2 n^3 per full product);
// the transpose-subtract and the combine by bytes (each reads and writes
// n^2 elements per matrix).  Which GEMM:
//   * psgd_norm_bound, psgd_tiled_step and psgd_scaled_matmul_trace in
//     bf16: the tensor-core GEMM of ns_gemm_sm90.cuh (TMA + wgmma, f32
//     accumulation, up to 989 TFLOP/s).  The bound's four thin products
//     read the stored bf16 matrix itself and bf16 copies of its f32
//     iterates (written by the start, the row normalizations and the thin
//     products' epilogues); the step's epilogue reads Q at the output
//     position and stores q - coeff (acc - term2 q) in bf16; the scaled
//     product's scales by inv[b], stores bf16 and writes each diagonal
//     128 x 128 tile's f32 diagonal sum.  n % 8 == 0 (16-byte rows for
//     TMA), else cudaErrorInvalidValue (the wrappers raise first), but for
//     psgd_norm_bound, which takes such a bf16 width on the FFMA GEMM (its
//     iterates rounded to bf16 as they are loaded), as the single route
//     does.
//   * every f32 entry: the FFMA gemm_kernel of ns_common.cuh with f32
//     products (~20 TFLOP/s at n = 2560).
//
// Storage points follow the TPU route: q1, R, Rq and RRq are stored in Q's
// dtype; the bound reads its matrix in that dtype, takes the start row from
// row energies in that dtype (first index on ties) and divides each thin
// product by the normalizer; the trace of a scaled product is summed from
// the f32 values before they are rounded; the elementwise pieces round
// once per f32 operation (__fsub_rn, __fmul_rn, __fadd_rn), as the plain
// versions do, so they agree bit for bit.
#include "ns_gemm_sm90.cuh"

namespace {

// q' = q1 + a rq + (a^2 / 2) rrq, evaluated left to right in f32 with one
// rounding per operation.  grid (blocks, B).
template <typename T>
__global__ void tiled_combine_kernel(const T* __restrict__ q1, const T* __restrict__ rq,
                                     const T* __restrict__ rrq,
                                     const float* __restrict__ a_step, long long nn,
                                     T* __restrict__ out) {
  const int b = blockIdx.y;
  const float a = a_step[b];
  const float c = __fmul_rn(__fmul_rn(0.5f, a), a);
  const long long off = (long long)b * nn;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nn;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = off + i;
    st(out, e, __fadd_rn(__fadd_rn(ld(q1, e), __fmul_rn(a, ld(rq, e))),
                         __fmul_rn(c, ld(rrq, e))));
  }
}

// trace[b] = sum of the (B, tiles) diagonal partials in a fixed order.
__global__ void trace_sum_kernel(const float* __restrict__ part, int tiles, int batch,
                                 float* __restrict__ trace) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float t = 0.f;
  for (int i = 0; i < tiles; ++i) t += part[(long long)b * tiles + i];
  trace[b] = t;
}

// The bound's scratch; in bf16 also the iterates' bf16 copies, which the
// tensor cores read.
long long carve_bound_only(float* base, int B, int n, int k, int dtype, BoundWs* ws) {
  Carver c(base);
  *ws = carve_bound(c, B, n, k, dtype != 0);
  return c.off;
}

// The bound of a stack stored as T; in bf16 the stored matrix is its own
// product operand on the tensor cores.
template <typename T, typename Gemm>
void bound(const T* mat, const uint32_t* seeds, float* out, const BoundWs& ws, int B, int n,
           int k, int mode, uint32_t tag, cudaStream_t st) {
  norm_bound<T, Gemm, true>(mat, mat, B, n, k, mode, seeds, tag, ws, st);
  bound_scalars(ws, B, k, kOutBound, nullptr, nullptr, 0.f, 0.f, 0.f, nullptr, out, st);
}

template <typename T>
void combine(const T* q1, const T* rq, const T* rrq, const float* a, T* out, int B,
             int n, cudaStream_t st) {
  const long long nn = (long long)n * n;
  int blocks = cdiv(nn, 256);
  if (blocks > 1024) blocks = 1024;
  tiled_combine_kernel<T><<<dim3(blocks, B), 256, 0, st>>>(q1, rq, rrq, a, nn, out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every (B, n, n) matrix argument;
// scalars per batch element are (B,) f32.  Each returns cudaGetLastError(),
// an entry on the tensor cores a failed tensor-map encoding first.

// Bytes of device scratch of psgd_norm_bound.
extern "C" long long psgd_bound_workspace_bytes(int B, int n, int k, int dtype) {
  BoundWs ws;
  return carve_bound_only(nullptr, B, n, k, dtype, &ws) * 4LL;
}

// out[b] = spectral-norm lower bound of mat[b] (mode 0 spd: normalizer max
// diag; 1 skh: max |a|), start drawn from Philox keyed by seeds[b] with
// word 1 ^ tag; in bf16 on the tensor cores at n % 8 == 0, else on the
// FFMA GEMM with bf16-rounded iterates.
extern "C" int psgd_norm_bound(const void* mat, const void* seeds, void* out,
                               void* workspace, int B, int n, int k, int dtype,
                               int mode, unsigned int tag, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* o = static_cast<float*>(out);
  BoundWs ws;
  carve_bound_only(static_cast<float*>(workspace), B, n, k, dtype, &ws);
  if (B > 0 && n > 0) {
    if (dtype == 0)
      bound<float, FfmaGemm<false>>(static_cast<const float*>(mat), sd, o, ws, B, n, k, mode,
                                    tag, st);
    else if (n % 8 == 0)
      bound<bf16, TcGemm>(static_cast<const bf16*>(mat), sd, o, ws, B, n, k, mode, tag, st);
    else
      bound<bf16, FfmaGemm<true>>(static_cast<const bf16*>(mat), sd, o, ws, B, n, k, mode,
                                  tag, st);
  }
  return tc_status();
}

// out = q - coeff (step q - term2 q), stored in Q's dtype; in bf16 (tensor
// cores) n % 8 == 0.
extern "C" int psgd_tiled_step(const void* step, const void* q, const void* coeff,
                               const void* term2, void* out, int B, int n, int dtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coeff);
  const float* t2 = static_cast<const float*>(term2);
  if (dtype != 0 && n % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B > 0 && n > 0) {
    if (dtype == 0)
      gemm<float, float, float, false>(static_cast<const float*>(step),
                                       static_cast<const float*>(q),
                                       static_cast<float*>(out), n, n, n, B, kStep, c, t2,
                                       nullptr, st);
    else
      tc_gemm<kStep, bf16>(static_cast<const bf16*>(step), static_cast<const bf16*>(q),
                           static_cast<bf16*>(out), nullptr, n, n, n, B, c, t2, nullptr, st);
  }
  return tc_status();
}

// r = x^T - x stored as out_dtype, and its bf16 copy into r16 unless null:
// the transpose-subtract as the NS chains instantiate it.  (in, out)
// dtypes: (f32, f32) the tiled route's tsub and the f32 chains, with r16 the
// bf16 single route's f32 q1; (bf16, f32) with r16 the split procrustes;
// (bf16, bf16) tsub.  Another pair: cudaErrorInvalidValue.
extern "C" int psgd_tsub(const void* x, void* r, void* r16, int B, int n, int in_dtype,
                         int out_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* r16h = static_cast<bf16*>(r16);
  if (in_dtype == 0 && out_dtype != 0) return (int)cudaErrorInvalidValue;
  if (B > 0 && n > 0) {
    if (in_dtype == 0)
      transpose_sub<float, float>(static_cast<const float*>(x), static_cast<float*>(r), r16h,
                                  B, n, st);
    else if (out_dtype == 0)
      transpose_sub<bf16, float>(static_cast<const bf16*>(x), static_cast<float*>(r), r16h, B,
                                 n, st);
    else
      transpose_sub<bf16, bf16>(static_cast<const bf16*>(x), static_cast<bf16*>(r), r16h, B,
                                n, st);
  }
  return (int)cudaGetLastError();
}

// Diagonal tiles per matrix of psgd_scaled_matmul_trace: the tile of its
// GEMM (tensor cores in bf16, FFMA in f32).
static int smm_tiles(int n, int dtype) { return cdiv(n, dtype == 0 ? kTile : kTcM); }

// Bytes of device scratch of psgd_scaled_matmul_trace (the trace partials).
extern "C" long long psgd_smm_workspace_bytes(int B, int n, int dtype) {
  Carver c(nullptr);
  c.take((long long)B * smm_tiles(n, dtype));
  return c.off * 4LL;
}

// Dynamic shared memory of one block of the tensor-core GEMM, in bytes.
extern "C" int psgd_tc_gemm_smem_bytes() { return kTcSmemBytes; }

// out = (a b) * inv in a's dtype, trace[b] = tr((a b) * inv) from the f32
// values; in bf16 (tensor cores) n % 8 == 0.
extern "C" int psgd_scaled_matmul_trace(const void* a, const void* b, const void* inv,
                                        void* out, void* trace, void* workspace, int B,
                                        int n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* iv = static_cast<const float*>(inv);
  float* part = static_cast<float*>(workspace);
  if (dtype != 0 && n % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B > 0 && n > 0) {
    if (dtype == 0)
      gemm<float, float, float, false>(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<float*>(out), n, n, n, B, kMulTrace, iv,
                                       nullptr, part, st);
    else
      tc_gemm<kMulTrace, bf16>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                               static_cast<bf16*>(out), nullptr, n, n, n, B, iv, nullptr,
                               part, st);
    trace_sum_kernel<<<cdiv(B, 128), 128, 0, st>>>(part, smm_tiles(n, dtype), B,
                                                    static_cast<float*>(trace));
  }
  return tc_status();
}

// out = q1 + a rq + (a^2 / 2) rrq, a (B,) f32.
extern "C" int psgd_tiled_combine(const void* q1, const void* rq, const void* rrq,
                                  const void* a, void* out, int B, int n, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* as = static_cast<const float*>(a);
  if (B > 0 && n > 0) {
    if (dtype == 0)
      combine<float>(static_cast<const float*>(q1), static_cast<const float*>(rq),
                     static_cast<const float*>(rrq), as, static_cast<float*>(out), B, n,
                     st);
    else
      combine<bf16>(static_cast<const bf16*>(q1), static_cast<const bf16*>(rq),
                    static_cast<const bf16*>(rrq), as, static_cast<bf16*>(out), B, n, st);
  }
  return (int)cudaGetLastError();
}
