// Batched Q0.5EQ1.5 matrix-factor update (the whitening fit's Newton-Schulz
// tail) as a short chain of launches on one stream.
//
// Replaces: psgd_torch_tpu/ops/pallas_kernels.py, _ns_kernel via
// fused_ns_update (one VMEM-resident monolith per factor on the TPU):
//   ell = norm_lower_bound_spd(term1) + term2
//   L'  = max(betaL L + (1 - betaL) ell, ell),   coeff = lr / L'
//   q1  = q - coeff (term1 q - term2 q)
//   q'  = procrustes_step2(q1): R = q1^T - q1, R /= norm_lower_bound_skh(R),
//         a = min(-tr(Rq1)/tr(RRq1), 1/8) if tr(RRq1) < 0 else 1/8,
//         q' = q1 + a Rq1 + a^2/2 RRq1
//
// Bound on the H100: operations.  Per factor 6 n^3 flops in the three full
// products (term1 q, R q1, R Rq1) plus 8 thin k x n by n x n products
// (2 k n^2 each) in the two norm bounds, against ~3 n^2 elements of HBM
// traffic that must move.  One n = 768 f32 matrix (2.4 MB) is ten times an
// SM's shared memory, so the TPU monolith cannot carry over: every product
// here is a shared-memory-tiled GEMM (64 x 64 tile per block, 16-deep k
// slices, 4 x 4 outputs per thread, FFMA with f32 accumulation), batched
// over the layer stack with blockIdx.z.  Simple and right first: no tensor
// cores, no TMA; it sits far below the bf16 tensor-core bound.
//
// Precision follows the TPU kernel's _dot: with a bf16 Q the product
// operands are rounded to bf16 and accumulated in f32; with an f32 Q the
// products are plain f32.  q1, R, Rq1 and RRq1 are stored in f32; only q'
// is stored in Q's dtype; L stays f32.
//
// No host sync: L', coeff, the bounds, the traces and the step a live in
// device scratch.  Traces are deterministic: each diagonal tile writes its
// partial sum to a (B, tiles) buffer, and the combine kernel sums them in a
// fixed order (no float atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kTiny = 1.17549435e-38f;  // finfo(float32).tiny, as the plain version
constexpr uint32_t kSkhTag = 0x5BD1E995u;  // separates the skew bound's stream
constexpr int kTile = 64, kDepth = 16, kThreads = 256;
enum Mode { kSpd = 0, kSkh = 1 };
enum Epilogue { kDiv = 0, kStep = 1, kDivTrace = 2 };

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

// Block-wide reductions for blockDim.x a multiple of 32 (<= 1024).
__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += sh[w];
  return t;
}

__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t = fmaxf(t, sh[w]);
  return t;
}

// C[b] = epilogue(A[b] (M x K) @ B[b] (K x N)), all row-major.
//   kDiv:      C = acc / den[b]
//   kStep:     C = Q - den[b] * (acc - term2[b] * Q)      (den = coeff)
//   kDivTrace: C = acc / den[b], and the tile's diagonal sum to trace[b, tile]
// kRound rounds both operands to bf16 (the bf16-Q precision of the TPU _dot).
template <typename TA, typename TB, bool kRound>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ Bm,
            float* __restrict__ C, int M, int N, int K, int epi,
            const float* __restrict__ den, const float* __restrict__ term2,
            float* __restrict__ trace) {
  __shared__ float As[kDepth][kTile + 4];  // As[k][m]
  __shared__ float Bs[kDepth][kTile + 4];  // Bs[k][n]
  __shared__ float diag[kTile];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const long long a_off = (long long)b * M * K, b_off = (long long)b * K * N,
                  c_off = (long long)b * M * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int i = tid; i < kTile * kDepth; i += kThreads) {
      const int mm = i / kDepth, kk = i % kDepth;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = (gm < M && gk < K) ? ld(A, a_off + (long long)gm * K + gk) : 0.f;
      As[kk][mm] = kRound ? bf16_round(v) : v;
    }
    for (int i = tid; i < kDepth * kTile; i += kThreads) {
      const int kk = i / kTile, nn = i % kTile;
      const int gk = k0 + kk, gn = n0 + nn;
      float v = (gk < K && gn < N) ? ld(Bm, b_off + (long long)gk * N + gn) : 0.f;
      Bs[kk][nn] = kRound ? bf16_round(v) : v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool tile_has_diag = (epi == kDivTrace) && (m0 == n0);
  if (tile_has_diag && tid < kTile) diag[tid] = 0.f;
  __syncthreads();
  const float d = den[b];
  const float t2 = (epi == kStep) ? term2[b] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        const long long idx = (long long)gm * N + gn;
        float v = acc[i][j];
        if (epi == kStep) {
          const float q = ld(Bm, b_off + idx);  // the step's right operand is Q
          v = q - d * (v - t2 * q);
        } else {
          v = v / d;
          if (tile_has_diag && gm == gn) diag[gm - m0] = v;
        }
        C[c_off + idx] = v;
      }
    }
  }
  if (tile_has_diag) {
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int i = 0; i < kTile; ++i) t += diag[i];
      trace[b * gridDim.y + blockIdx.y] = t;
    }
  }
}

// Per row r of A[b]: energy = sum a^2, and rowval = a[r][r] (spd) or
// max_c |a[r][c]| (skh).  grid (n, B).
template <typename T>
__global__ void row_stats_kernel(const T* __restrict__ A, int n, int mode,
                                 float* __restrict__ energy,
                                 float* __restrict__ rowval) {
  __shared__ float sh[32];
  const int r = blockIdx.x, b = blockIdx.y;
  const long long row = ((long long)b * n + r) * n;
  float e = 0.f, mx = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float v = ld(A, row + c);
    e = fmaf(v, v, e);
    mx = fmaxf(mx, fabsf(v));
  }
  e = block_sum(e, sh);
  mx = block_max(mx, sh);
  if (threadIdx.x == 0) {
    energy[(long long)b * n + r] = e;
    rowval[(long long)b * n + r] = (mode == kSpd) ? ld(A, row + r) : mx;
  }
}

// Per batch: s = max rowval + tiny, j = first row of maximal energy.  grid (B).
__global__ void select_kernel(const float* __restrict__ energy,
                              const float* __restrict__ rowval, int n,
                              float* __restrict__ s, int* __restrict__ j) {
  __shared__ float sv[256];
  __shared__ float se[256];
  __shared__ int si[256];
  const int b = blockIdx.x, t = threadIdx.x;
  float vmax = -INFINITY, emax = -INFINITY;
  int eidx = n;
  for (int r = t; r < n; r += blockDim.x) {
    const float v = rowval[(long long)b * n + r], e = energy[(long long)b * n + r];
    vmax = fmaxf(vmax, v);
    if (e > emax) { emax = e; eidx = r; }
  }
  sv[t] = vmax; se[t] = emax; si[t] = eidx;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (t < o) {
      sv[t] = fmaxf(sv[t], sv[t + o]);
      const float e2 = se[t + o];
      const int i2 = si[t + o];
      if (e2 > se[t] || (e2 == se[t] && i2 < si[t])) { se[t] = e2; si[t] = i2; }
    }
    __syncthreads();
  }
  if (t == 0) {
    s[b] = sv[0] + kTiny;
    j[b] = si[0] < n ? si[0] : 0;
  }
}

// Subspace start row r: v = a_j/s + sgn(<a_j/s, u>) u with u uniform(-1, 1)
// from Philox keyed by the batch element's seed words (word 1 ^ tag).
// grid (k, B); out is (B, k, n) f32.
template <typename T>
__global__ void start_kernel(const T* __restrict__ A, const float* __restrict__ s,
                             const int* __restrict__ j,
                             const uint32_t* __restrict__ seeds, uint32_t tag,
                             int n, float* __restrict__ out) {
  __shared__ float sh[32];
  const int r = blockIdx.x, b = blockIdx.y, k = gridDim.x;
  const uint32_t k0 = seeds[2 * b], k1 = seeds[2 * b + 1] ^ tag;
  const long long arow = ((long long)b * n + j[b]) * n;
  const float sb = s[b];
  float dot = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float u = (psgd::float_in_1_2(psgd::philox_word(k0, k1, (long long)r * n + c)) - 1.5f) * 2.0f;
    dot = fmaf(ld(A, arow + c) / sb, u, dot);
  }
  dot = block_sum(dot, sh);
  const float sg = dot > 0.f ? 1.f : (dot < 0.f ? -1.f : 0.f);
  float* o = out + ((long long)b * k + r) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float u = (psgd::float_in_1_2(psgd::philox_word(k0, k1, (long long)r * n + c)) - 1.5f) * 2.0f;
    o[c] = ld(A, arow + c) / sb + sg * u;
  }
}

// Row norms of V (B, k, n) into norms (B, k); with normalize, V's rows are
// divided by (norm + tiny) in place.  grid (k, B).
__global__ void row_norm_kernel(float* __restrict__ V, int n, int normalize,
                                float* __restrict__ norms) {
  __shared__ float sh[32];
  const int r = blockIdx.x, b = blockIdx.y, k = gridDim.x;
  float* row = V + ((long long)b * k + r) * n;
  float ss = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) ss = fmaf(row[c], row[c], ss);
  const float nrm = sqrtf(block_sum(ss, sh));
  if (normalize) {
    const float dn = nrm + kTiny;
    for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = row[c] / dn;
  }
  if (threadIdx.x == 0) norms[(long long)b * k + r] = nrm;
}

// bound = s * max_r norms;  spd: ell = bound + term2, L' and coeff = lr / L';
// skh: den = bound + tiny (the divisor of R).  One thread per batch element.
__global__ void bound_scalars_kernel(const float* __restrict__ norms, int k,
                                     const float* __restrict__ s, int batch,
                                     int mode, const float* __restrict__ term2,
                                     const float* __restrict__ lips, float lr,
                                     float beta, float one_minus_beta,
                                     float* __restrict__ lips_out,
                                     float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float m = 0.f;
  for (int r = 0; r < k; ++r) m = fmaxf(m, norms[(long long)b * k + r]);
  const float bound = s[b] * m;
  if (mode == kSpd) {
    const float ell = bound + term2[b];
    const float L = fmaxf(beta * lips[b] + one_minus_beta * ell, ell);
    lips_out[b] = L;
    out[b] = lr / L;
  } else {
    out[b] = bound + kTiny;
  }
}

// R = Q1^T - Q1 through a 32 x 33 shared tile.  grid (tiles, tiles, B),
// block (32, 8).
__global__ void transpose_sub_kernel(const float* __restrict__ Q1, int n,
                                     float* __restrict__ R) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, bx = blockIdx.x * 32, by = blockIdx.y * 32;
  const long long off = (long long)b * n * n;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = bx + i, c = by + tx;
    if (r < n && c < n) tile[i][tx] = Q1[off + (long long)r * n + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = by + i, c = bx + tx;
    if (r < n && c < n) R[off + (long long)r * n + c] = tile[tx][i] - Q1[off + (long long)r * n + c];
  }
}

// q' = q1 + a (Rq1 + a/2 RRq1), a from the traces summed in a fixed order.
// grid (blocks, B).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ q1,
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
    st(out, off + i, q1[off + i] + a * (rq[off + i] + half_a * rrq[off + i]));
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

template <typename TA, typename TB, bool kRound>
void gemm(const TA* A, const TB* Bm, float* C, int M, int N, int K, int batch,
          int epi, const float* den, const float* term2, float* trace,
          cudaStream_t s) {
  const dim3 grid(cdiv(N, kTile), cdiv(M, kTile), batch);
  gemm_kernel<TA, TB, kRound><<<grid, kThreads, 0, s>>>(A, Bm, C, M, N, K, epi, den,
                                                        term2, trace);
}

// Scratch layout (float units, each piece 64-aligned).
struct Workspace {
  float *s, *energy, *rowval, *v, *w, *norms, *coeff, *den, *q1, *r, *rq, *rrq,
      *tr1, *tr2;
  int* j;
};

inline long long al(long long x) { return (x + 63) / 64 * 64; }

long long carve(float* base, int B, int n, int k, Workspace* ws) {
  const long long nn = (long long)n * n;
  const int tiles = cdiv(n, kTile);
  long long o = 0;
  auto take = [&](long long count) {
    float* p = base ? base + o : nullptr;
    o += al(count);
    return p;
  };
  ws->s = take(B);
  ws->j = reinterpret_cast<int*>(take(B));
  ws->energy = take((long long)B * n);
  ws->rowval = take((long long)B * n);
  ws->v = take((long long)B * k * n);
  ws->w = take((long long)B * k * n);
  ws->norms = take((long long)B * k);
  ws->coeff = take(B);
  ws->den = take(B);
  ws->q1 = take(B * nn);
  ws->r = take(B * nn);
  ws->rq = take(B * nn);
  ws->rrq = take(B * nn);
  ws->tr1 = take((long long)B * tiles);
  ws->tr2 = take((long long)B * tiles);
  return o;
}

// Subspace-iteration norm bound of A (B, n, n): leaves s (normalizer) in
// ws.s and the final row norms in ws.norms.  bound = s * max(norms).
template <typename TA, bool kRound>
void norm_bound(const TA* A, int B, int n, int k, int mode,
                const uint32_t* seeds, uint32_t tag, Workspace& ws,
                cudaStream_t st) {
  row_stats_kernel<TA><<<dim3(n, B), 128, 0, st>>>(A, n, mode, ws.energy, ws.rowval);
  select_kernel<<<B, 256, 0, st>>>(ws.energy, ws.rowval, n, ws.s, ws.j);
  start_kernel<TA><<<dim3(k, B), 256, 0, st>>>(A, ws.s, ws.j, seeds, tag, n, ws.v);
  // two half-iterations: v = v A/s; v /= |v|; v = v A/s   (twice)
  gemm<float, TA, kRound>(ws.v, A, ws.w, k, n, n, B, kDiv, ws.s, nullptr, nullptr, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.w, n, 1, ws.norms);
  gemm<float, TA, kRound>(ws.w, A, ws.v, k, n, n, B, kDiv, ws.s, nullptr, nullptr, st);
  gemm<float, TA, kRound>(ws.v, A, ws.w, k, n, n, B, kDiv, ws.s, nullptr, nullptr, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.w, n, 1, ws.norms);
  gemm<float, TA, kRound>(ws.w, A, ws.v, k, n, n, B, kDiv, ws.s, nullptr, nullptr, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.v, n, 0, ws.norms);
}

template <typename T, bool kRound>
void ns_update(const T* term1, const T* q, const float* lips, const float* term2,
               const uint32_t* seeds, T* q_out, float* lips_out, float* base,
               int B, int n, int k, float lr, float beta, float one_minus_beta,
               float max_step, cudaStream_t st) {
  Workspace ws;
  carve(base, B, n, k, &ws);
  const long long nn = (long long)n * n;
  const int tiles = cdiv(n, kTile);
  const int sblocks = cdiv(B, 128);

  // ell, L' and coeff = lr / L'
  norm_bound<T, kRound>(term1, B, n, k, kSpd, seeds, 0u, ws, st);
  bound_scalars_kernel<<<sblocks, 128, 0, st>>>(ws.norms, k, ws.s, B, kSpd, term2,
                                                 lips, lr, beta, one_minus_beta,
                                                 lips_out, ws.coeff);
  // q1 = q - coeff (term1 q - term2 q): operands are exact in Q's dtype
  gemm<T, T, false>(term1, q, ws.q1, n, n, n, B, kStep, ws.coeff, term2, nullptr, st);
  // R = q1^T - q1 and its skew bound (den = bound + tiny)
  transpose_sub_kernel<<<dim3(cdiv(n, 32), cdiv(n, 32), B), dim3(32, 8), 0, st>>>(
      ws.q1, n, ws.r);
  norm_bound<float, kRound>(ws.r, B, n, k, kSkh, seeds, kSkhTag, ws, st);
  bound_scalars_kernel<<<sblocks, 128, 0, st>>>(ws.norms, k, ws.s, B, kSkh, nullptr,
                                                 nullptr, 0.f, 0.f, 0.f, nullptr,
                                                 ws.den);
  // Rq1 = (R / den) q1 and RRq1 = (R / den) Rq1, with diagonal partial sums
  gemm<float, float, kRound>(ws.r, ws.q1, ws.rq, n, n, n, B, kDivTrace, ws.den,
                             nullptr, ws.tr1, st);
  gemm<float, float, kRound>(ws.r, ws.rq, ws.rrq, n, n, n, B, kDivTrace, ws.den,
                             nullptr, ws.tr2, st);
  int cblocks = cdiv(nn, 256);
  if (cblocks > 1024) cblocks = 1024;
  combine_kernel<T><<<dim3(cblocks, B), 256, 0, st>>>(ws.q1, ws.rq, ws.rrq, ws.tr1,
                                                       ws.tr2, tiles, max_step, nn,
                                                       q_out);
}

}  // namespace

// Bytes of device scratch psgd_ns_update needs for B factors of width n and
// subspace dimension k.
extern "C" long long psgd_ns_workspace_bytes(int B, int n, int k) {
  Workspace ws;
  return carve(nullptr, B, n, k, &ws) * (long long)sizeof(float);
}

// dtype: 0 = float32 (f32 products), 1 = bfloat16 (bf16 operands, f32
// accumulation).  term1, q, q_out: (B, n, n); lips, term2, lips_out: (B,)
// f32; seeds: (B, 2) 32-bit words.  Returns cudaGetLastError().
extern "C" int psgd_ns_update(const void* term1, const void* q, const void* lips,
                              const void* term2, const void* seeds, void* q_out,
                              void* lips_out, void* workspace, int B, int n, int k,
                              int dtype, float lr, float beta, float one_minus_beta,
                              float max_step, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lips);
  const float* t2 = static_cast<const float*>(term2);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* lo = static_cast<float*>(lips_out);
  float* ws = static_cast<float*>(workspace);
  if (B > 0 && n > 0) {
    if (dtype == 0)
      ns_update<float, false>(static_cast<const float*>(term1),
                              static_cast<const float*>(q), l, t2, sd,
                              static_cast<float*>(q_out), lo, ws, B, n, k, lr, beta,
                              one_minus_beta, max_step, st);
    else
      ns_update<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(term1),
                                     static_cast<const __nv_bfloat16*>(q), l, t2, sd,
                                     static_cast<__nv_bfloat16*>(q_out), lo, ws, B, n,
                                     k, lr, beta, one_minus_beta, max_step, st);
  }
  return (int)cudaGetLastError();
}
