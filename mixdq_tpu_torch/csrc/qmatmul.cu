// W8A8 dense GEMM with fused dequant epilogue.
//
// Replaces mixdq_tpu/ops/pallas_qmatmul.py:qmatmul (pallas_call at :109),
// the hand-written kernel the JAX package keeps for qops.qlinear (XLA
// there). For codes x [M, K] and weights w [K, N] (row-major, as
// deployed):
//
//   out = (float(acc) - bias0) * scale (+ bias)      -> bf16 or f32 [M, N]
//
// acc converts to f32 before bias0 is subtracted, as qops.qlinear does
// (the Pallas kernel subtracts in int32; bias0 is integer-valued, so the
// two agree while |acc| < 2^24). One block owns a 64x64 output tile and
// loops over the whole K (mma_s8.cuh:gemm_tile), so there is no
// cross-block reduction; tails in M, N and K read zero codes, which add
// 0. Bound, at the main-path shapes: the weight bytes at M <= 256 (e.g.
// M=1 K=1280 N=1280: 1.6 MB, ~0.5 us at 3.35 TB/s), int8 operations at
// M=4096 K=960 N=320 (2.5 GOP, ~1.3 us at 1,979 TOP/s). With one 64-row
// tile for M=1 and no split-K, the small-M layers run far from either.

#include "mma_s8.cuh"

using namespace mixdq;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias0,
                   const float* __restrict__ bias, T* __restrict__ out, int M,
                   int K, int N, bool avec, bool bvec) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bs[BN][LDS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  gemm_tile(x, M, K, m0, avec, w, N, n0, bvec, As, Bs,
            [&](int m, int n, int acc) {
              if (m >= M || n >= N) return;
              float v = __fmul_rn(__fsub_rn(__int2float_rn(acc), bias0[n]),
                                  scale[n]);
              if (bias) v = __fadd_rn(v, bias[n]);
              store_f32(out + static_cast<size_t>(m) * N + n, v);
            });
}

extern "C" int mixdq_qmatmul(const int8_t* x, const int8_t* w,
                             const float* scale, const float* bias0,
                             const float* bias, void* out, int M, int K,
                             int N, int out_bf16, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const bool avec = vec16(x, K), bvec = vec16(w, N);
  if (out_bf16) {
    qmatmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias0, bias, static_cast<__nv_bfloat16*>(out), M, K, N,
        avec, bvec);
  } else {
    qmatmul_kernel<float><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias0, bias, static_cast<float*>(out), M, K, N, avec,
        bvec);
  }
  return static_cast<int>(cudaGetLastError());
}
