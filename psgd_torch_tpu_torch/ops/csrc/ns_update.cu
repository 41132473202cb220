// Batched Q0.5EQ1.5 matrix-factor update (the whitening fit's Newton-Schulz
// tail) as a short chain of launches on one stream: the single route and
// the two stages of the split route.
//
// Replaces: psgd_torch_tpu/ops/pallas_kernels.py
//   * _ns_kernel via fused_ns_update (one VMEM-resident monolith per factor
//     on the TPU): psgd_ns_update;
//   * _ns_step_kernel and _procrustes_kernel via _split_ns_update (the
//     two-kernel split with q1 round-tripping through HBM in Q's dtype):
//     psgd_ns_step and psgd_procrustes.
// The function:
//   ell = norm_lower_bound_spd(term1) + term2
//   L'  = max(betaL L + (1 - betaL) ell, ell),   coeff = lr / L'
//   q1  = q - coeff (S q - term2 q),  S = step_mat if given, else term1
//         (the TPU kernels' has_step_mat: the Newton fit passes
//         term1 = A + B and S = A - B; the bound still reads term1)
//   q'  = procrustes_step2(q1): R = q1^T - q1, R /= norm_lower_bound_skh(R),
//         a = min(-tr(Rq1)/tr(RRq1), 1/8) if tr(RRq1) < 0 else 1/8,
//         q' = q1 + a Rq1 + a^2/2 RRq1
//
// Bound on the H100: operations.  Per factor 6 n^3 flops in the three full
// products (S q, R q1, R Rq1) plus 8 thin k x n by n x n products
// (2 k n^2 each) in the two norm bounds, against ~3 n^2 elements of HBM
// traffic that must move.  One n = 768 f32 matrix (2.4 MB) is ten times an
// SM's shared memory, so the TPU monolith cannot carry over: every product
// is a GEMM over shared-memory tiles.  Which GEMM:
//   * every entry in bf16 at n % 8 == 0 (16-byte rows for TMA): the
//     tensor-core GEMM of ns_gemm_sm90.cuh (TMA + wgmma, f32 accumulation,
//     up to 989 TFLOP/s) for every product: the step product and the four
//     thin products of the spd bound; procrustes's two full products and
//     the four thin products of its skew bound.  TMA loads only what is in
//     memory, so every f32 operand that the FFMA GEMM rounded to bf16 at
//     load gets a bf16 copy written beside it, rounded once to the same
//     value: the bounds' iterates, the single route's f32 q1 (by the step
//     product's epilogue), R (by the transpose-subtract) and Rq1 (by the
//     first procrustes product's epilogue).
//   * the single route in bf16 at n % 8 != 0, which TMA cannot load (the
//     route for "anything else" may be sent such a width): the FFMA
//     gemm_kernel of ns_common.cuh, rounding its operands to bf16 at load.
//     A rule on shape: nothing tries one GEMM and falls back to the other.
//     psgd_ns_step and psgd_procrustes refuse such widths
//     (cudaErrorInvalidValue; the wrappers raise first).
//   * every entry in f32: the FFMA gemm_kernel with f32 products, ~20
//     TFLOP/s at n = 2048.
//
// Precision follows the TPU kernels' _dot: with a bf16 Q the product
// operands are rounded to bf16 and accumulated in f32; with an f32 Q the
// products are plain f32.  R, Rq1 and RRq1 are stored in f32, q' in Q's
// dtype, L in f32.  q1 is stored in f32 by the single route (as the
// monolith keeps it in VMEM) and in Q's dtype between the split's stages
// (as _split_ns_update writes it to HBM): the same template, another TQ1.
//
// No host sync: L', coeff, the bounds, the traces and the step a live in
// device scratch.  Traces are deterministic: each diagonal tile writes its
// partial sum to a (B, tiles) buffer, and the combine kernel sums them in a
// fixed order (no float atomics).
#include "ns_gemm_sm90.cuh"

namespace {

// q' = q1 + a (Rq1 + a/2 RRq1), a from the traces summed in a fixed order.
// grid (blocks, B).
template <typename TQ1, typename T>
__global__ void combine_kernel(const TQ1* __restrict__ q1,
                               const float* __restrict__ rq,
                               const float* __restrict__ rrq,
                               const float* __restrict__ tr_rq,
                               const float* __restrict__ tr_rrq, int tiles,
                               float max_step, long long nn, T* __restrict__ out) {
  const int b = blockIdx.y;
  float t1 = 0.f, t2 = 0.f;
  for (int i = 0; i < tiles; ++i) {
    t1 += tr_rq[b * tiles + i];
    t2 += tr_rrq[b * tiles + i];
  }
  const float a = (t2 < 0.f) ? fminf(-t1 / t2, max_step) : max_step;
  const float half_a = 0.5f * a;
  const long long off = (long long)b * nn;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nn;
       i += (long long)gridDim.x * blockDim.x)
    st(out, off + i, ld(q1, off + i) + a * (rq[off + i] + half_a * rrq[off + i]));
}

// Parts of the scratch a chain needs (kPartHalf: the bf16 copies that the
// tensor-core GEMM reads, of the bound's iterates, of q1 and of R and Rq1).
enum Part { kPartStep = 1, kPartQ1 = 2, kPartProc = 4, kPartHalf = 8 };

// Whether an entry's chain runs on the tensor cores, by dtype and shape.
bool on_tensor_cores(int n, int dtype) { return dtype != 0 && n % 8 == 0; }

struct NsWs {
  BoundWs bound;
  float *coeff, *q1, *den, *r, *rq, *rrq, *tr1, *tr2;
  bf16 *q1_16 = nullptr, *r16 = nullptr, *rq16 = nullptr;
};

long long carve(float* base, int B, int n, int k, int parts, NsWs* ws) {
  const long long nn = (long long)n * n;
  const int tiles = cdiv(n, kTile);
  Carver c(base);
  ws->bound = carve_bound(c, B, n, k, parts & kPartHalf);
  if (parts & kPartStep) ws->coeff = c.take(B);
  if (parts & kPartQ1) {
    ws->q1 = c.take(B * nn);
    if (parts & kPartHalf) ws->q1_16 = reinterpret_cast<bf16*>(c.take((B * nn + 1) / 2));
  }
  if (parts & kPartProc) {
    ws->den = c.take(B);
    ws->r = c.take(B * nn);
    ws->rq = c.take(B * nn);
    ws->rrq = c.take(B * nn);
    // the FFMA GEMM's 64-row diagonal tiles outnumber the tensor cores' 128
    ws->tr1 = c.take((long long)B * tiles);
    ws->tr2 = c.take((long long)B * tiles);
    if (parts & kPartHalf) {
      ws->r16 = reinterpret_cast<bf16*>(c.take((B * nn + 1) / 2));
      ws->rq16 = reinterpret_cast<bf16*>(c.take((B * nn + 1) / 2));
    }
  }
  return c.off;
}

// Stage 1: ell (from term1), L' and coeff = lr / L', then q1 = q - coeff
// (s q - term2 q) stored as TQ1 (the operands are exact in Q's dtype), and
// as bf16 into q1_16 if given; s is the step matrix, term1 itself unless the
// caller passed another.  The bound's thin products and the step product
// on the GEMM policy Gemm.
template <typename T, typename TQ1, typename Gemm>
void ns_step_chain(const T* term1, const T* s, const T* q, const float* lips,
                   const float* term2, const uint32_t* seeds, TQ1* q1, bf16* q1_16,
                   float* lips_out, const NsWs& ws, int B, int n, int k, float lr,
                   float beta, float one_minus_beta, cudaStream_t st) {
  norm_bound<T, Gemm, false>(term1, term1, B, n, k, kSpd, seeds, 0u, ws.bound, st);
  bound_scalars(ws.bound, B, k, kOutLips, term2, lips, lr, beta, one_minus_beta,
                lips_out, ws.coeff, st);
  Gemm::step(s, q, q1, q1_16, n, B, ws.coeff, term2, st);
}

// Stage 2: procrustes_step2 of q1 (TQ1) with R, Rq1 and RRq1 in f32; the
// bound's thin products and the two full products on the GEMM policy Gemm,
// which reads q1, R and Rq1 as it takes them (as stored, or their bf16
// copies: q1_16 is q1 itself for a bf16 q1).
template <typename T, typename TQ1, typename Gemm>
void procrustes_chain(const TQ1* q1, const bf16* q1_16, const uint32_t* seeds, T* q_out,
                      const NsWs& ws, int B, int n, int k, float max_step,
                      cudaStream_t st) {
  const long long nn = (long long)n * n;
  // R = q1^T - q1 and its skew bound (den = bound + tiny)
  transpose_sub<TQ1, float>(q1, ws.r, ws.r16, B, n, st);
  const auto* r = Gemm::operand(ws.r, ws.r16);
  norm_bound<float, Gemm, false>(ws.r, r, B, n, k, kSkh, seeds, kSkhTag, ws.bound, st);
  bound_scalars(ws.bound, B, k, kOutDen, nullptr, nullptr, 0.f, 0.f, 0.f, nullptr,
                ws.den, st);
  // Rq1 = (R / den) q1 and RRq1 = (R / den) Rq1, with diagonal partial sums
  Gemm::div_trace(r, Gemm::operand(q1, q1_16), ws.rq, ws.rq16, n, B, ws.den, ws.tr1, st);
  Gemm::div_trace(r, Gemm::operand(ws.rq, ws.rq16), ws.rrq, nullptr, n, B, ws.den, ws.tr2,
                  st);
  int cblocks = cdiv(nn, 256);
  if (cblocks > 1024) cblocks = 1024;
  combine_kernel<TQ1, T><<<dim3(cblocks, B), 256, 0, st>>>(
      q1, ws.rq, ws.rrq, ws.tr1, ws.tr2, cdiv(n, Gemm::kTraceTile), max_step, nn, q_out);
}

// The single route: both stages with q1 kept in f32 (and, for the tensor
// cores, its bf16 copy).
template <typename T, typename Gemm>
void ns_update(const T* term1, const T* s, const T* q, const float* lips,
               const float* term2, const uint32_t* seeds, T* q_out, float* lips_out,
               const NsWs& ws, int B, int n, int k, float lr, float beta,
               float one_minus_beta, float max_step, cudaStream_t st) {
  ns_step_chain<T, float, Gemm>(term1, s, q, lips, term2, seeds, ws.q1, ws.q1_16, lips_out,
                                ws, B, n, k, lr, beta, one_minus_beta, st);
  procrustes_chain<T, float, Gemm>(ws.q1, ws.q1_16, seeds, q_out, ws, B, n, k, max_step, st);
}

// The parts of an entry's scratch: its chain's, and the bf16 copies when
// the chain runs on the tensor cores.
int parts_of(int parts, int n, int dtype) {
  return on_tensor_cores(n, dtype) ? parts | kPartHalf : parts;
}

constexpr int kSingle = kPartStep | kPartQ1 | kPartProc;

}  // namespace

// Bytes of device scratch for B factors of width n, subspace dimension k
// and dtype (0 = float32, 1 = bfloat16): the single route
// (psgd_ns_update), stage 1 (psgd_ns_step) and stage 2 (psgd_procrustes)
// of the split route.
extern "C" long long psgd_ns_workspace_bytes(int B, int n, int k, int dtype) {
  NsWs ws;
  return carve(nullptr, B, n, k, parts_of(kSingle, n, dtype), &ws) * 4LL;
}
extern "C" long long psgd_ns_step_workspace_bytes(int B, int n, int k, int dtype) {
  NsWs ws;
  return carve(nullptr, B, n, k, parts_of(kPartStep, n, dtype), &ws) * 4LL;
}
extern "C" long long psgd_procrustes_workspace_bytes(int B, int n, int k, int dtype) {
  NsWs ws;
  return carve(nullptr, B, n, k, parts_of(kPartProc, n, dtype), &ws) * 4LL;
}

// The single route.  dtype: 0 = float32 (f32 products), 1 = bfloat16 (bf16
// operands, f32 accumulation: on the tensor cores at n % 8 == 0, else on
// the FFMA GEMM).  term1, q, q_out: (B, n, n); step_mat: (B, n, n) or null
// (the step reads term1); lips, term2, lips_out: (B,) f32; seeds: (B, 2)
// 32-bit words.  Returns a failed tensor-map encoding, else
// cudaGetLastError().
extern "C" int psgd_ns_update(const void* term1, const void* step_mat, const void* q,
                              const void* lips, const void* term2, const void* seeds,
                              void* q_out, void* lips_out, void* workspace, int B, int n,
                              int k, int dtype, float lr, float beta, float one_minus_beta,
                              float max_step, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lips);
  const float* t2 = static_cast<const float*>(term2);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* lo = static_cast<float*>(lips_out);
  NsWs ws;
  carve(static_cast<float*>(workspace), B, n, k, parts_of(kSingle, n, dtype), &ws);
  const void* s = step_mat ? step_mat : term1;
  if (B > 0 && n > 0) {
    const bf16* t1h = static_cast<const bf16*>(term1);
    const bf16* sh = static_cast<const bf16*>(s);
    const bf16* qh = static_cast<const bf16*>(q);
    bf16* oh = static_cast<bf16*>(q_out);
    if (dtype == 0)
      ns_update<float, FfmaGemm<false>>(static_cast<const float*>(term1),
                                        static_cast<const float*>(s),
                                        static_cast<const float*>(q), l, t2, sd,
                                        static_cast<float*>(q_out), lo, ws, B, n, k, lr,
                                        beta, one_minus_beta, max_step, st);
    else if (on_tensor_cores(n, dtype))
      ns_update<bf16, TcGemm>(t1h, sh, qh, l, t2, sd, oh, lo, ws, B, n, k, lr, beta,
                              one_minus_beta, max_step, st);
    else
      ns_update<bf16, FfmaGemm<true>>(t1h, sh, qh, l, t2, sd, oh, lo, ws, B, n, k, lr, beta,
                                      one_minus_beta, max_step, st);
  }
  return tc_status();
}

// Split stage 1 (_ns_step_kernel): the spd bound of term1, L' into
// lips_out and q1 into q1_out, both in Q's dtype.  Arguments as
// psgd_ns_update (step_mat null: the step reads term1); in bf16 (tensor
// cores) n % 8 == 0.
extern "C" int psgd_ns_step(const void* term1, const void* step_mat, const void* q,
                            const void* lips, const void* term2, const void* seeds,
                            void* q1_out, void* lips_out, void* workspace, int B, int n,
                            int k, int dtype, float lr, float beta, float one_minus_beta,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lips);
  const float* t2 = static_cast<const float*>(term2);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* lo = static_cast<float*>(lips_out);
  NsWs ws;
  carve(static_cast<float*>(workspace), B, n, k, parts_of(kPartStep, n, dtype), &ws);
  if (dtype != 0 && n % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* s = step_mat ? step_mat : term1;
  if (B > 0 && n > 0) {
    if (dtype == 0)
      ns_step_chain<float, float, FfmaGemm<false>>(
          static_cast<const float*>(term1), static_cast<const float*>(s),
          static_cast<const float*>(q), l, t2, sd, static_cast<float*>(q1_out), nullptr,
          lo, ws, B, n, k, lr, beta, one_minus_beta, st);
    else
      ns_step_chain<bf16, bf16, TcGemm>(
          static_cast<const bf16*>(term1), static_cast<const bf16*>(s),
          static_cast<const bf16*>(q), l, t2, sd, static_cast<bf16*>(q1_out), nullptr,
          lo, ws, B, n, k, lr, beta, one_minus_beta, st);
  }
  return tc_status();
}

// Split stage 2 (_procrustes_kernel): procrustes_step2 of q1 (B, n, n) in
// Q's dtype into q_out, its skew bound keyed by seed word 1 ^ 0x5BD1E995;
// in bf16 (tensor cores) n % 8 == 0.
extern "C" int psgd_procrustes(const void* q1, const void* seeds, void* q_out,
                               void* workspace, int B, int n, int k, int dtype,
                               float max_step, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  NsWs ws;
  carve(static_cast<float*>(workspace), B, n, k, parts_of(kPartProc, n, dtype), &ws);
  if (dtype != 0 && n % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B > 0 && n > 0) {
    if (dtype == 0) {
      procrustes_chain<float, float, FfmaGemm<false>>(static_cast<const float*>(q1), nullptr,
                                                      sd, static_cast<float*>(q_out), ws, B,
                                                      n, k, max_step, st);
    } else {
      const bf16* q1h = static_cast<const bf16*>(q1);
      procrustes_chain<bf16, bf16, TcGemm>(q1h, q1h, sd, static_cast<bf16*>(q_out), ws, B, n,
                                           k, max_step, st);
    }
  }
  return tc_status();
}
