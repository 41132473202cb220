// Device code shared by the Newton-Schulz (NS) update kernels: block
// reductions, the tiled FFMA GEMM with its epilogues, the
// subspace-iteration norm bound, the transpose-subtract and the scratch
// layout of the bound.  Included by ns_update.cu (the single and split
// routes) and ns_tiled.cu (the tiled route), directly and through
// ns_gemm_sm90.cuh; each includes it once, so the anonymous namespace gives
// each translation unit its own instances.
//
// Which GEMM runs where.  Every bf16 product with n % 8 == 0 runs on the
// tensor-core GEMM of ns_gemm_sm90.cuh (TMA + wgmma): those of the single
// route (psgd_ns_update), psgd_ns_step, psgd_procrustes, psgd_norm_bound,
// psgd_tiled_step and psgd_scaled_matmul_trace.  gemm_kernel below runs
// the rest: every f32 product (f32 operands, never TF32), and the bf16
// products of the single route at a width n % 8 != 0, which TMA cannot
// load (a rule on shape; the other bf16 entries refuse such widths).
// norm_bound, ns_step_chain and procrustes_chain take the GEMM as a policy
// type (FfmaGemm here, TcGemm there).
//
// Bound on the H100 of every GEMM here: operations.  gemm_kernel is simple
// and right first: a 64 x 64 output tile per block, 16-deep k slices
// through shared memory, 4 x 4 outputs per thread, FFMA with f32
// accumulation, batched over the layer stack with blockIdx.z.  No tensor
// cores, no TMA: ~20 TFLOP/s at n = 2048-2560, far below the bf16
// tensor-core bound.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

constexpr float kTiny = 1.17549435e-38f;  // finfo(float32).tiny, as the plain versions
constexpr uint32_t kSkhTag = 0x5BD1E995u;  // separates the skew bound's stream
constexpr int kTile = 64, kDepth = 16, kThreads = 256;
enum Mode { kSpd = 0, kSkh = 1 };
// GEMM epilogues (den is a per-batch scalar on the device):
//   kDiv:      C = acc / den[b]
//   kStep:     C = Q - den[b] * (acc - term2[b] * Q)      (den = lr / L')
//   kDivTrace: C = acc / den[b], diagonal partial sums to trace[b, tile]
//   kMulTrace: C = acc * den[b], diagonal partial sums to trace[b, tile]
enum Epilogue { kDiv = 0, kStep = 1, kDivTrace = 2, kMulTrace = 3 };
// What bound_scalars_kernel writes from the bound s * max(norms):
//   kOutLips:  ell = bound + term2, L' = max(beta L + (1 - beta) ell, ell)
//              to lips_out and lr / L' to out
//   kOutDen:   bound + tiny (the divisor of R)
//   kOutBound: the bound itself
enum ScalarOut { kOutLips = 0, kOutDen = 1, kOutBound = 2 };

typedef __nv_bfloat16 bf16;
using psgd::bf16_round;
using psgd::ld;
using psgd::st;
using psgd::stored;

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

// C[b] = epilogue(A[b] (M x K) @ B[b] (K x N)), all row-major, C stored as
// TC (f32 or Q's dtype; the trace partials come from the f32 values before
// that rounding).  kRound rounds both operands to bf16 (the bf16-Q
// precision of the TPU kernels' _dot).
template <typename TA, typename TB, typename TC, bool kRound>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ Bm,
            TC* __restrict__ C, int M, int N, int K, int epi,
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

  const bool traced = epi == kDivTrace || epi == kMulTrace;
  const bool tile_has_diag = traced && (m0 == n0);
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
          v = (epi == kMulTrace) ? v * d : v / d;
          if (tile_has_diag && gm == gn) diag[gm - m0] = v;
        }
        st(C, c_off + idx, v);
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
// max_c |a[r][c]| (skh).  kStoredEnergy takes the energy in the storage
// type T, as the TPU's tiled bound does: each square rounded to T, the sum
// accumulated in f32 and rounded to T.  grid (n, B).
template <typename T, bool kStoredEnergy>
__global__ void row_stats_kernel(const T* __restrict__ A, int n, int mode,
                                 float* __restrict__ energy,
                                 float* __restrict__ rowval) {
  __shared__ float sh[32];
  const int r = blockIdx.x, b = blockIdx.y;
  const long long row = ((long long)b * n + r) * n;
  float e = 0.f, mx = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float v = ld(A, row + c);
    e = kStoredEnergy ? e + stored<T>(v * v) : fmaf(v, v, e);
    mx = fmaxf(mx, fabsf(v));
  }
  e = block_sum(e, sh);
  mx = block_max(mx, sh);
  if (threadIdx.x == 0) {
    energy[(long long)b * n + r] = kStoredEnergy ? stored<T>(e) : e;
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
// grid (k, B); out is (B, k, n) f32, out16 (if given) its bf16 copy.
template <typename T>
__global__ void start_kernel(const T* __restrict__ A, const float* __restrict__ s,
                             const int* __restrict__ j,
                             const uint32_t* __restrict__ seeds, uint32_t tag,
                             int n, float* __restrict__ out, bf16* __restrict__ out16) {
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
  const long long o = ((long long)b * k + r) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float u = (psgd::float_in_1_2(psgd::philox_word(k0, k1, (long long)r * n + c)) - 1.5f) * 2.0f;
    const float v = ld(A, arow + c) / sb + sg * u;
    out[o + c] = v;
    if (out16) st(out16, o + c, v);
  }
}

// Row norms of V (B, k, n) into norms (B, k); with normalize, V's rows are
// divided by (norm + tiny) in place, and V16 (if given) gets their bf16
// copy.  grid (k, B).
__global__ void row_norm_kernel(float* __restrict__ V, bf16* __restrict__ V16, int n,
                                int normalize, float* __restrict__ norms) {
  __shared__ float sh[32];
  const int r = blockIdx.x, b = blockIdx.y, k = gridDim.x;
  float* row = V + ((long long)b * k + r) * n;
  float ss = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) ss = fmaf(row[c], row[c], ss);
  const float nrm = sqrtf(block_sum(ss, sh));
  if (normalize) {
    const float dn = nrm + kTiny;
    bf16* row16 = V16 ? V16 + ((long long)b * k + r) * n : nullptr;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      row[c] = row[c] / dn;
      if (row16) st(row16, c, row[c]);
    }
  }
  if (threadIdx.x == 0) norms[(long long)b * k + r] = nrm;
}

// bound = s * max_r norms, then what ScalarOut says.  One thread per batch
// element.
__global__ void bound_scalars_kernel(const float* __restrict__ norms, int k,
                                     const float* __restrict__ s, int batch,
                                     int what, const float* __restrict__ term2,
                                     const float* __restrict__ lips, float lr,
                                     float beta, float one_minus_beta,
                                     float* __restrict__ lips_out,
                                     float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float m = 0.f;
  for (int r = 0; r < k; ++r) m = fmaxf(m, norms[(long long)b * k + r]);
  const float bound = s[b] * m;
  if (what == kOutLips) {
    const float ell = bound + term2[b];
    const float L = fmaxf(beta * lips[b] + one_minus_beta * ell, ell);
    lips_out[b] = L;
    out[b] = lr / L;
  } else {
    out[b] = (what == kOutDen) ? bound + kTiny : bound;
  }
}

// R = Q1^T - Q1: one f32 subtraction (__fsub_rn), one rounding to TO, and
// (if R16 is given) one to bf16 for a bf16 copy.
//
// Bound on the H100: bytes, each element of Q1 read once and each of R
// (and R16) written once.  R[I, J] and R[J, I] read the same two tiles,
// Q1[I, J] and Q1[J, I], so one block takes one unordered pair of 64 x 64
// tiles (I <= J; a diagonal tile is one tile), loads both into shared
// memory once and writes both tiles of R, every element of R computed by
// its own subtraction (R[J, I] is not -R[I, J]^T: x - x is +0, -(x - x)
// is -0).  Global accesses are V consecutive elements of a row: 16-byte
// vectors of Q1 (V = 8 in bf16, 4 in f32) where n % V == 0 and the arrays
// are 16-byte aligned, else V = 1, by shape.  The tiles sit in shared
// memory as f32 with rows padded to 65 words, so the transposed reads are
// at most two-way bank conflicts.  grid (tile pairs, B), 256 threads.
constexpr int kTsubTile = 64, kTsubThreads = 256;

template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kTsubThreads)
transpose_sub_kernel(const TI* __restrict__ Q1, int n, TO* __restrict__ R,
                     bf16* __restrict__ R16) {
  __shared__ float sh[2][kTsubTile][kTsubTile + 1];
  // the pair (I, J), I <= J, of triangular index p = J (J + 1) / 2 + I
  const int p = blockIdx.x;
  int J = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while ((J + 1) * (J + 2) / 2 <= p) ++J;
  while (J * (J + 1) / 2 > p) --J;
  const int I = p - J * (J + 1) / 2;
  const int tiles = I == J ? 1 : 2;
  const long long off = (long long)blockIdx.y * n * n;
  constexpr int kPerRow = kTsubTile / V, kRows = kTsubThreads / kPerRow;
  const int tr = threadIdx.x / kPerRow, tc = (threadIdx.x % kPerRow) * V;
  // sh[0] = Q1[I, J] and sh[1] = Q1[J, I]
  for (int s = 0; s < tiles; ++s) {
    const int r0 = (s ? J : I) * kTsubTile, c = (s ? I : J) * kTsubTile + tc;
    for (int i = tr; i < kTsubTile; i += kRows) {
      if (r0 + i < n && c < n) {
        float v[V];
        psgd::ldv<V>(Q1 + off + (long long)(r0 + i) * n + c, v);
#pragma unroll
        for (int k = 0; k < V; ++k) sh[s][i][tc + k] = v[k];
      }
    }
  }
  __syncthreads();
  // R[I, J][i][j] = sh[1][j][i] - sh[0][i][j] and R[J, I][i][j] = sh[0][j][i] - sh[1][i][j]
  for (int s = 0; s < tiles; ++s) {
    const float(*x)[kTsubTile + 1] = sh[s];
    const float(*y)[kTsubTile + 1] = sh[tiles - 1 - s];
    const int r0 = (s ? J : I) * kTsubTile, c = (s ? I : J) * kTsubTile + tc;
    for (int i = tr; i < kTsubTile; i += kRows) {
      if (r0 + i < n && c < n) {
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = __fsub_rn(y[tc + k][i], x[i][tc + k]);
        const long long idx = off + (long long)(r0 + i) * n + c;
        psgd::stv<V>(R + idx, v);
        if (R16) psgd::stv<V>(R16 + idx, v);
      }
    }
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

template <typename TA, typename TB, typename TC, bool kRound>
void gemm(const TA* A, const TB* Bm, TC* C, int M, int N, int K, int batch,
          int epi, const float* den, const float* term2, float* trace,
          cudaStream_t s) {
  const dim3 grid(cdiv(N, kTile), cdiv(M, kTile), batch);
  gemm_kernel<TA, TB, TC, kRound><<<grid, kThreads, 0, s>>>(A, Bm, C, M, N, K, epi,
                                                            den, term2, trace);
}

// The transpose-subtract of a (B, n, n) stack: 16-byte vectors where the
// rows and arrays allow them, else scalar accesses (a rule on shape).
template <typename TI, typename TO>
void transpose_sub(const TI* Q1, TO* R, bf16* R16, int B, int n, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(TI);
  const int tiles = cdiv(n, kTsubTile);
  const dim3 grid(tiles * (tiles + 1) / 2, B);
  if (n % kV == 0 && psgd::aligned16(Q1, R, R16))
    transpose_sub_kernel<TI, TO, kV><<<grid, kTsubThreads, 0, s>>>(Q1, n, R, R16);
  else
    transpose_sub_kernel<TI, TO, 1><<<grid, kTsubThreads, 0, s>>>(Q1, n, R, R16);
}

// Scratch is carved from one float buffer, each piece 64-aligned; with a
// null base only the size is counted.
struct Carver {
  float* base;
  long long off = 0;
  explicit Carver(float* b) : base(b) {}
  float* take(long long count) {
    float* p = base ? base + off : nullptr;
    off += (count + 63) / 64 * 64;
    return p;
  }
};

// The norm bound's scratch: normalizer, argmax row, row statistics, the
// (B, k, n) iterates, their bf16 copies (for a GEMM that reads bf16
// operands; null without half) and their row norms.
struct BoundWs {
  float *s, *energy, *rowval, *v, *w, *norms;
  bf16 *vh = nullptr, *wh = nullptr;
  int* j;
};

inline BoundWs carve_bound(Carver& c, int B, int n, int k, bool half = false) {
  BoundWs ws;
  ws.s = c.take(B);
  ws.j = reinterpret_cast<int*>(c.take(B));
  ws.energy = c.take((long long)B * n);
  ws.rowval = c.take((long long)B * n);
  ws.v = c.take((long long)B * k * n);
  ws.w = c.take((long long)B * k * n);
  ws.norms = c.take((long long)B * k);
  if (half) {
    ws.vh = reinterpret_cast<bf16*>(c.take(((long long)B * k * n + 1) / 2));
    ws.wh = reinterpret_cast<bf16*>(c.take(((long long)B * k * n + 1) / 2));
  }
  return ws;
}

// The FFMA products of the bound, the step and procrustes (the policy
// norm_bound, ns_step_chain and procrustes_chain take; TcGemm in
// ns_gemm_sm90.cuh is the other).  kRound rounds the operands to bf16 as
// they are loaded.
template <bool kRound>
struct FfmaGemm {
  // the diagonal tile of the trace partials
  static constexpr int kTraceTile = kTile;
  // the copy of an operand that the products read: the operand itself
  template <typename T>
  static const T* operand(const T* p, const bf16*) { return p; }
  // w (k x n, f32) = v (k x n, f32) a / s; the bf16 copies are not used
  template <typename TA>
  static void thin(const float* v, const bf16*, const TA* a, float* w, bf16*, int k, int n,
                   int batch, const float* s, cudaStream_t st) {
    gemm<float, TA, float, kRound>(v, a, w, k, n, n, batch, kDiv, s, nullptr, nullptr, st);
  }
  // q1 = q - coeff (s q - term2 q) for the step matrix s (term1, or the
  // Newton fit's separate S), stored as TQ1; no bf16 copy
  template <typename T, typename TQ1>
  static void step(const T* s, const T* q, TQ1* q1, bf16*, int n, int batch,
                   const float* coeff, const float* term2, cudaStream_t st) {
    gemm<T, T, TQ1, false>(s, q, q1, n, n, n, batch, kStep, coeff, term2, nullptr, st);
  }
  // c (n x n, f32) = a b / den, the diagonal partials to trace; no bf16 copy
  template <typename TA, typename TB>
  static void div_trace(const TA* a, const TB* b, float* c, bf16*, int n, int batch,
                        const float* den, float* trace, cudaStream_t st) {
    gemm<TA, TB, float, kRound>(a, b, c, n, n, n, batch, kDivTrace, den, nullptr, trace, st);
  }
};

// Subspace-iteration norm bound of A (B, n, n) held in its storage type TA,
// its thin products on the GEMM policy Gemm, which reads A as P: A itself,
// or its bf16 copy for the tensor cores.  Leaves the normalizer s in ws.s
// and the final row norms in ws.norms, so bound = s * max(norms).  The
// normalizer divides each thin product (not the matrix, which is never
// copied): each row normalization is scale-invariant, so this is the same
// bound.  A policy that reads bf16 iterates gets their copies (ws.vh,
// ws.wh) from the start, the row normalizations and the thin products
// themselves: each copy is the f32 iterate rounded to bf16 once, the value
// FfmaGemm<true> rounds it to at load.
template <typename TA, typename Gemm, bool kStoredEnergy, typename TP>
void norm_bound(const TA* A, const TP* P, int B, int n, int k, int mode,
                const uint32_t* seeds, uint32_t tag, const BoundWs& ws,
                cudaStream_t st) {
  row_stats_kernel<TA, kStoredEnergy><<<dim3(n, B), 128, 0, st>>>(A, n, mode, ws.energy,
                                                                  ws.rowval);
  select_kernel<<<B, 256, 0, st>>>(ws.energy, ws.rowval, n, ws.s, ws.j);
  start_kernel<TA><<<dim3(k, B), 256, 0, st>>>(A, ws.s, ws.j, seeds, tag, n, ws.v, ws.vh);
  // two half-iterations: v = v A/s; v /= |v|; v = v A/s   (twice)
  Gemm::thin(ws.v, ws.vh, P, ws.w, ws.wh, k, n, B, ws.s, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.w, ws.wh, n, 1, ws.norms);
  Gemm::thin(ws.w, ws.wh, P, ws.v, ws.vh, k, n, B, ws.s, st);
  Gemm::thin(ws.v, ws.vh, P, ws.w, ws.wh, k, n, B, ws.s, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.w, ws.wh, n, 1, ws.norms);
  Gemm::thin(ws.w, ws.wh, P, ws.v, nullptr, k, n, B, ws.s, st);
  row_norm_kernel<<<dim3(k, B), 256, 0, st>>>(ws.v, nullptr, n, 0, ws.norms);
}

inline void bound_scalars(const BoundWs& ws, int B, int k, int what,
                          const float* term2, const float* lips, float lr, float beta,
                          float one_minus_beta, float* lips_out, float* out,
                          cudaStream_t st) {
  bound_scalars_kernel<<<cdiv(B, 128), 128, 0, st>>>(ws.norms, k, ws.s, B, what, term2,
                                                      lips, lr, beta, one_minus_beta,
                                                      lips_out, out);
}

}  // namespace
