// W8A8 NHWC implicit-GEMM convolution with fused epilogue.
//
// Replaces mixdq_tpu/ops/pallas_qconv.py:qconv2d_pallas (pallas_call at
// :437) and, through the `stride` argument, qconv2d_pallas_s2 (:500),
// which the TPU runs as a stride-1 conv over a space-to-depth input; a
// direct strided gather computes the same sums.
//
//   out[b,p,q,k] = (acc - bias0[k]) * scale[k] + bias[k] + ebias[b,k]
//                  + residual[b,p,q,k]
//   acc = sum_{r,s,c} xpad[b, p*stride + r, q*stride + s, c] * w[r,s,c,k]
//
// where out-of-image taps read the zero-point code `zp` (so bias0 is one
// constant per channel). GEMM view: M = B*P*Q pixels, N = K channels,
// Kdim = kh*kw*C, with the HWIO weight read as a row-major [Kdim, K]
// matrix. bias and ebias are read in their stored type (f32 or bf16).
// Bound: int8 operations at large maps (conv 320->320 @ 64x64, 7.5 GOP,
// ~3.8 us at 1,979 TOP/s) and the weight bytes at small maps (conv
// 2560->1280 @ 16x16, 29.5 MB, ~8.8 us at 3.35 TB/s).
//
// Design: the pipelined mainloop of igemm_s8.cuh with an im2col A loader:
// with C % 16 == 0 a 16-byte chunk is 16 channels of one tap, copied by
// cp.async when the tap is in the image and written as 16 zp codes by a
// plain shared store when it is not (both land before the step's
// barrier); each thread carries its chunks' taps from step to step, so a
// step divides nothing. C % 16 != 0 (conv_in, C = 4) gathers bytes.
// Stride 2 is the same gather at doubled offsets. The plan (split-K) is
// ops/qconv.py:qconv_plan, qmm_plan over Kdim; split-K is reduced by the
// last block of each tile in the same launch. Waves on 132 SMs (tiles x
// splits = blocks, steps of 128 k per split):
//   320->320 @64x64     M=4096  96 x 1 = 96     (23 steps)
//   1920->640 @32x32    M=1024  40 x 3 = 120    (45 each)
//   2560->1280 @16x16   M=256   20 x 6 = 120    (30 each)
//   1280->1280 @16x16   M=256   20 x 6 = 120    (15 each)
//   4->320 @64x64       M=4096  96 x 1 = 96     (one partial step, bytes)
//   320->4 @64x64       M=4096  32 x 4 = 128    (6 each; one live warp
//                       column of four, 4-byte weight copies)
//   320->320 s2 @64x64  M=1024  24 x 5 = 120    (5 each)
//   640->640 s2 @32x32  M=256   10 x 12 = 120   (4 each, 1 the last)

#include "igemm_s8.cuh"

using namespace mixdq;
using igemm::BSrc;
using igemm::EpiArgs;

struct ConvGeom {
  int M, PQ, Q, stride, ph, pw;
};

template <typename T, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    qconv_kernel(igemm::ConvA<FAST> a, ConvGeom geo, BSrc b, EpiArgs e,
                 int Kdim, int split_k, int* ws, unsigned* counters) {
  a.init(blockIdx.y * igemm::BM, geo.M, geo.PQ, geo.Q, geo.stride, geo.ph,
         geo.pw, blockIdx.z * split_k);
  igemm::run_block<T, FAST>(a, b, e, Kdim, split_k, ws, counters);
}

template <typename T, bool FAST>
static int launch(const igemm::ConvA<FAST>& a, const ConvGeom& geo,
                  const BSrc& b, const EpiArgs& e, int Kdim, int splits,
                  int split_k, int* ws, unsigned* counters,
                  cudaStream_t stream) {
  static const cudaError_t attrs = igemm::set_smem(qconv_kernel<T, FAST>);
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((e.N + igemm::BN - 1) / igemm::BN,
                  (e.M + igemm::BM - 1) / igemm::BM, splits);
  qconv_kernel<T, FAST><<<grid, igemm::NT, igemm::SMEM, stream>>>(
      a, geo, b, e, Kdim, split_k, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte copies of A and B known at compile time (FAST), or chosen
// at run time.
template <typename T>
static int launch_any(const igemm::ConvA<false>& a, const ConvGeom& geo,
                      const BSrc& b, const EpiArgs& e, int Kdim, int splits,
                      int split_k, int* ws, unsigned* counters,
                      cudaStream_t stream) {
  if (a.vec && b.mode == igemm::B_COPY16) {
    const igemm::ConvA<true> f{a.x, a.H, a.W, a.C, a.kw, a.zp, true,
                               {nullptr, nullptr}, {0, 0}, {0, 0}};
    return launch<T, true>(f, geo, b, e, Kdim, splits, split_k, ws,
                           counters, stream);
  }
  return launch<T, false>(a, geo, b, e, Kdim, splits, split_k, ws, counters,
                          stream);
}

// x [B, H, W, C] int8, w [kh, kw, C, K] int8, scale / bias0 [K] f32,
// bias [K] and ebias [B, K] f32 or bf16 (their flags) or null, res and
// out [B, P, Q, K] of the output type (res may be null). bm, stages,
// splits, split_k: the plan of ops/qconv.py:qconv_plan; ws: int32
// [tiles, splits, 128, 128] and counters: tiles zeroed uint32 when
// splits > 1.
extern "C" int mixdq_qconv2d(const int8_t* x, const int8_t* w,
                             const float* scale, const float* bias0,
                             const void* bias, int bias_bf16,
                             const void* ebias, int ebias_bf16,
                             const void* res, void* out, int* ws,
                             unsigned* counters, int B, int H, int W, int C,
                             int K, int kh, int kw, int stride, int ph,
                             int pw, int zp, int out_bf16, int bm,
                             int stages, int splits, int split_k,
                             cudaStream_t stream) {
  const int Kdim = kh * kw * C;
  if (!igemm::plan_ok(bm, stages, splits, split_k, Kdim, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = (H + 2 * ph - kh) / stride + 1;
  const int Q = (W + 2 * pw - kw) / stride + 1;
  const int M = B * P * Q;
  const igemm::ConvA<false> a{x, H, W, C, kw, zp, C % 16 == 0 && vec16(x, C),
                              {nullptr, nullptr}, {0, 0}, {0, 0}};
  const ConvGeom geo{M, P * Q, Q, stride, ph, pw};
  const BSrc b{w, K, igemm::b_mode(w, K)};
  const EpiArgs e{scale, bias0, bias, ebias, res, out, M, K, P * Q,
                  bias_bf16 != 0, ebias_bf16 != 0,
                  reinterpret_cast<uintptr_t>(res) % 16 == 0};
  return out_bf16 ? launch_any<__nv_bfloat16>(a, geo, b, e, Kdim, splits,
                                              split_k, ws, counters, stream)
                  : launch_any<float>(a, geo, b, e, Kdim, splits, split_k,
                                      ws, counters, stream);
}
