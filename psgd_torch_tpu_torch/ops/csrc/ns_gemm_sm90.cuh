// The Hopper tensor-core GEMM of the bf16 NS products: TMA loads into a
// ring of shared-memory stages, wgmma with f32 accumulators in registers,
// and the epilogues of ns_common.cuh fused after the mainloop.
//
//   C[b] = epilogue(A[b] (M x K) @ B[b] (K x N)), bf16 operands, row-major
//
// Used for every bf16 product at n % 8 == 0: by the single route
// (psgd_ns_update: its step product, its two full procrustes products and
// the thin products of its two bounds), psgd_ns_step and psgd_procrustes
// (ns_update.cu), and by psgd_norm_bound, psgd_tiled_step and
// psgd_scaled_matmul_trace (ns_tiled.cu).  The f32 products, and the single
// route's bf16 products at n % 8 != 0, keep the FFMA gemm_kernel of
// ns_common.cuh.
//
// Bound on the H100: operations (2 M N K at 989 TFLOP/s in bf16); the
// FFMA GEMM it replaces ran at ~20 TFLOP/s without tensor cores.  Design:
//   * one 128 x 128 output tile per block, k in slices of 64;
//   * one producer warp: a single thread issues three TMA loads per slice
//     (A: a 128 x 64 box, K-major; B: two 64 x 64 boxes, N-major) into a
//     4-stage ring of 32 KB stages with a 128-byte swizzle, and completes
//     the stage's "full" mbarrier by transaction bytes;
//   * two consumer warpgroups, 64 rows each: per slice four
//     wgmma.mma_async m64n128k16 (A K-major, B MN-major through the
//     instruction's transpose bit, so no transposed copy of B is made),
//     one group kept in flight, the stage released on its "empty" mbarrier
//     when the group that read it has completed;
//   * each (B, rows, cols) operand is a 3-D tensor map, so a box never
//     straddles two batch entries, and TMA zero-fills the ragged edges;
//     the epilogue masks its stores.  Rows need 16-byte strides: n % 8 == 0.
// The tensor maps are encoded on the host per call, cuTensorMapEncodeTiled
// looked up through the CUDA runtime (nothing links -lcuda), and passed as
// __grid_constant__ kernel parameters; the dynamic shared-memory attribute
// is set once per kernel instantiation and device.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ns_common.cuh"

namespace {

constexpr int kTcM = 128, kTcN = 128, kTcK = 64, kTcStages = 4;
constexpr int kTcConsumers = 256, kTcThreads = kTcConsumers + 32;
constexpr int kTcABytes = kTcM * kTcK * 2;  // 16 KB
constexpr int kTcBBytes = kTcK * kTcN * 2;  // 16 KB, two 64 x 64 boxes
constexpr int kTcStageBytes = kTcABytes + kTcBBytes;
// the ring, plus slack to align it to the 1024 bytes of the swizzle pattern
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + 1024;
// devices whose shared-memory attribute tc_gemm remembers having set
constexpr int kTcMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (c0 innermost) into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// K-major (A): rows of 64 bf16; sbo = 1024 bytes between 8-row groups, lbo
// unused.  MN-major (B): 64-wide column boxes; lbo = the bytes between two
// boxes along N, sbo = 1024 bytes between 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major), f32 accumulation.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The epilogues (ns_common.cuh), with den[b] and term2[b] read on the card:
//   kDiv:      C = acc / den[b] stored f32, and as bf16 into C16 if given
//              (the next thin product's operand);
//   kStep:     C = Q - den[b] (acc - term2[b] Q), Q = B read at the output
//              position, stored as TC (bf16; or f32, and as bf16 into C16
//              if given);
//   kDivTrace: as kDiv, and a diagonal tile writes the sum of its f32
//              diagonal to trace[b, tile row];
//   kMulTrace: C = acc * den[b] stored bf16, the diagonal sums as kDivTrace.
template <int kEpi, typename TC>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
               TC* __restrict__ C, __nv_bfloat16* __restrict__ C16,
               const __nv_bfloat16* __restrict__ Bm, const float* __restrict__ den,
               const float* __restrict__ term2, float* __restrict__ trace) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];
  __shared__ float diag[kTcM];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int b = blockIdx.z, m0 = blockIdx.y * kTcM, n0 = blockIdx.x * kTcN;
  const int ktiles = (K + kTcK - 1) / kTcK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);   // the producer's expect_tx
      mbar_init(smem_addr(&empty[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kTcM) diag[tid] = 0.f;
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer warp: one thread issues the loads
    if (tid == kTcConsumers) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kTcStages;
        // the first round finds every stage empty (parity of the phase before)
        mbar_wait(smem_addr(&empty[s]), ((kt / kTcStages) & 1) ^ 1);
        const uint32_t a_dst = ring + s * kTcStageBytes, b_dst = a_dst + kTcABytes;
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load(a_dst, &map_a, bar, kt * kTcK, m0, b);
        tma_load(b_dst, &map_b, bar, n0, kt * kTcK, b);
        tma_load(b_dst + kTcBBytes / 2, &map_b, bar, n0 + kTcN / 2, kt * kTcK, b);
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kTcStages;
    mbar_wait(smem_addr(&full[s]), (kt / kTcStages) & 1);
    const uint32_t a_tile = ring + s * kTcStageBytes + wg * (64 * kTcK * 2);
    const uint32_t b_tile = ring + s * kTcStageBytes + kTcABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)  // k16 steps: 32 bytes along A's rows,
      wgmma_m64n128k16(acc, sw128_desc(a_tile + kk * 32, 16, 1024),  // 16 rows of B
                       sw128_desc(b_tile + kk * 16 * 128, kTcBBytes / 2, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's group is done: release its stage
    if (kt > 0 && t == 0) mbar_arrive(smem_addr(&empty[(kt - 1) % kTcStages]));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout of m64nNk16: acc[4j + 2h + e] is row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the warpgroup's
  // 64 x 128 tile.
  const int warp = t / 32, lane = t % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const float d = den[b];
  const float t2 = (kEpi == kStep) ? term2[b] : 0.f;
  const bool has_diag = (kEpi == kDivTrace || kEpi == kMulTrace) && (m0 == n0);
  const long long c_off = (long long)b * M * N, q_off = (long long)b * K * N;
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j) {
    const int gn = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + 8 * h;
      if (gm >= M || gn >= N) continue;  // N is even, so gn + 1 < N too
      const long long idx = (long long)gm * N + gn;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (kEpi == kStep) {
        const float2 q =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Bm + q_off + idx));
        v0 = q.x - d * (v0 - t2 * q.x);
        v1 = q.y - d * (v1 - t2 * q.y);
      } else {
        v0 = (kEpi == kMulTrace) ? v0 * d : v0 / d;
        v1 = (kEpi == kMulTrace) ? v1 * d : v1 / d;
        if (has_diag && gm == gn) diag[gm - m0] = v0;
        if (has_diag && gm == gn + 1) diag[gm - m0] = v1;
      }
      if constexpr (sizeof(TC) == 4) {
        *reinterpret_cast<float2*>(C + c_off + idx) = make_float2(v0, v1);
        if (C16)
          *reinterpret_cast<__nv_bfloat162*>(C16 + c_off + idx) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(C + c_off + idx) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if (has_diag) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < kTcM; ++i) s += diag[i];
      trace[b * gridDim.y + blockIdx.y] = s;
    }
  }
}

// Host side.  The first failure of a tensor-map encoding in this process's
// current entry call, as 10000 + its CUresult (0 if none); the C entry
// points return it through tc_status().
inline int& tc_error() {
  static thread_local int e = 0;
  return e;
}

// The status of an entry call that may have launched the tensor-core GEMM:
// a host-side failure first, else cudaGetLastError().  Clears the former.
inline int tc_status() {
  const int e = tc_error();
  tc_error() = 0;
  return e ? e : (int)cudaGetLastError();
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*,
                                         const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A (batch, rows, cols) row-major bf16 stack as a 3-D tensor map with
// (1, box_rows, 64) boxes, 128-byte swizzle, zero fill out of bounds.
inline bool encode_stack(CUtensorMap* map, const __nv_bfloat16* ptr, int batch, int rows,
                         int cols, int box_rows) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (!enc) {
    tc_error() = 10000 + (int)CUDA_ERROR_NOT_FOUND;
    return false;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<__nv_bfloat16*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS && !tc_error()) tc_error() = 10000 + (int)r;
  return r == CUDA_SUCCESS;
}

// C[b] = epilogue(A[b] (M x K) @ Bm[b] (K x N)) for bf16 stacks with K and N
// multiples of 8 (the callers check); C16 only with an f32 C.
template <int kEpi, typename TC>
void tc_gemm(const __nv_bfloat16* A, const __nv_bfloat16* Bm, TC* C, __nv_bfloat16* C16,
             int M, int N, int K, int batch, const float* den, const float* term2,
             float* trace, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  if (!encode_stack(&map_a, A, batch, M, K, kTcM) ||
      !encode_stack(&map_b, Bm, batch, K, N, kTcK))
    return;
  const auto kernel = tc_gemm_kernel<kEpi, TC>;
  // the dynamic shared-memory limit, raised once per instantiation and device
  static bool sized[kTcMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kTcMaxDevices || !sized[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
    if (dev < kTcMaxDevices) sized[dev] = true;
  }
  const dim3 grid(cdiv(N, kTcN), cdiv(M, kTcM), batch);
  kernel<<<grid, kTcThreads, kTcSmemBytes, st>>>(map_a, map_b, M, N, K, C, C16, Bm, den,
                                                 term2, trace);
}

// The tensor-core products of the bf16 chains (the policy norm_bound,
// ns_step_chain and procrustes_chain take; FfmaGemm in ns_common.cuh is the
// other).  Each product reads the bf16 copies of its f32 operands: of the
// bound's iterates, of q1 (the single route), of R and of Rq1.  Templates,
// as FfmaGemm's, so a unit that does not call them builds no kernel.
struct TcGemm {
  // the diagonal tile of the trace partials
  static constexpr int kTraceTile = kTcM;
  // the copy of an f32 operand that the products read: its bf16 copy
  template <typename T>
  static const bf16* operand(const T*, const bf16* p16) { return p16; }
  // w (k x n, f32, and its bf16 copy w16 if given) = v16 (k x n) a / s
  template <typename TA>
  static void thin(const float*, const bf16* v16, const TA* a, float* w, bf16* w16, int k,
                   int n, int batch, const float* s, cudaStream_t st) {
    tc_gemm<kDiv, float>(v16, a, w, w16, k, n, n, batch, s, nullptr, nullptr, st);
  }
  // c (n x n, f32, and its bf16 copy c16 if given) = a b / den, the
  // diagonal partials to trace; a and b are bf16
  template <typename TA, typename TB>
  static void div_trace(const TA* a, const TB* b, float* c, bf16* c16, int n, int batch,
                        const float* den, float* trace, cudaStream_t st) {
    tc_gemm<kDivTrace, float>(a, b, c, c16, n, n, n, batch, den, nullptr, trace, st);
  }
  // q1 = q - coeff (s q - term2 q) for the step matrix s (term1, or the
  // Newton fit's separate S; a TMA map is encoded over whichever it is),
  // stored as TQ1 (bf16, or f32 and its bf16 copy q1_16 in the same epilogue)
  template <typename T, typename TQ1>
  static void step(const T* s, const T* q, TQ1* q1, bf16* q1_16, int n, int batch,
                   const float* coeff, const float* term2, cudaStream_t st) {
    tc_gemm<kStep, TQ1>(s, q, q1, q1_16, n, n, n, batch, coeff, term2, nullptr, st);
  }
};

}  // namespace
