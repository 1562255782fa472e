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
// two agree while |acc| < 2^24). bias is read in its stored type (f32 or
// bf16). Bound, at the main-path shapes: the weight bytes at M <= 256
// (M=1 K=1280 N=1280: 1.6 MB, ~0.5 us at 3.35 TB/s; 256x5120x1280: 6.6
// MB, ~2.5 us), int8 operations at M >= 1024 (1024x2560x640: 3.4 GOP,
// ~1.7 us at 1,979 TOP/s).
//
// Design: the pipelined mma.sync mainloop of igemm_s8.cuh (cp.async ring
// of 128-byte k steps, B kept [k][n] and transposed in registers, 128 x
// 128 tiles of 8 warps, split-K reduced by the last block of each tile in
// the same launch), its A loader reading the row-major codes. The plan is
// ops/qmatmul.py:qmm_plan: split K only where the tiles fill fewer SMs
// than the card has, into at most SMs / tiles ranges of at least two
// steps. Waves on 132 SMs (tiles x splits = blocks, steps per split):
//   1024x2560x640   40 x 3 = 120   (7, 7, 6)
//   1024x640x640    40 x 2 = 80    (3, 2)
//   4096x960x320    96 x 1 = 96    (8, the last one partial)
//   256x5120x1280   20 x 6 = 120   (7 each, 5 the last)
//   256x1280x1280   20 x 5 = 100   (2 each)
//   77x2048x2560    20 x 6 = 120   (3 each, 1 the last; 5 live m16 tiles)
//   77x2048x1280    10 x 8 = 80    (2 each)
//   1x1280x1280     10 x 5 = 50    (2 each; one live m16 tile)
//
// A layer axis (the shared-input banks of quant/deploy.py): x [L, M, K],
// w [L, K, N], scale / bias0 [L, N], out [L, M, N] in one grid whose z
// holds L x splits; each member runs the per-layer mainloop, split-K
// reduction and epilogue at its own offsets (its split-K tiles and
// counters after the earlier members'), so its output equals a per-layer
// launch bit for bit. The plan is the per-layer one on SMs / L.

#include "igemm_s8.cuh"

using namespace mixdq;
using igemm::BSrc;
using igemm::EpiArgs;

template <typename T, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    qmatmul_kernel(igemm::DenseA<FAST> a, BSrc b, EpiArgs e, int splits,
                   int split_k, int* ws, unsigned* counters) {
  // blockIdx.z = layer * splits + split; one layer: the plain grid
  const int layer = blockIdx.z / splits, split = blockIdx.z % splits;
  const size_t mk = static_cast<size_t>(a.M) * a.K;
  a.x += layer * mk;
  b.w += layer * static_cast<size_t>(a.K) * e.N;
  e.scale += static_cast<size_t>(layer) * e.N;
  e.bias0 += static_cast<size_t>(layer) * e.N;
  e.out = static_cast<T*>(e.out) + layer * static_cast<size_t>(e.M) * e.N;
  a.init(blockIdx.y * igemm::BM);
  const int tiles = gridDim.x * gridDim.y;
  igemm::run_tile<T, FAST, false>(
      a, b, e, a.K, blockIdx.y * igemm::BM, blockIdx.x * igemm::BN,
      layer * tiles + blockIdx.y * gridDim.x + blockIdx.x, split, splits,
      split_k, ws, counters);
}

template <typename T, bool FAST>
static int launch(const igemm::DenseA<FAST>& a, const BSrc& b,
                  const EpiArgs& e, int L, int splits, int split_k, int* ws,
                  unsigned* counters, cudaStream_t stream) {
  static const cudaError_t attrs = igemm::set_smem(qmatmul_kernel<T, FAST>);
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((e.N + igemm::BN - 1) / igemm::BN,
                  (e.M + igemm::BM - 1) / igemm::BM, L * splits);
  qmatmul_kernel<T, FAST><<<grid, igemm::NT, igemm::SMEM, stream>>>(
      a, b, e, splits, split_k, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte copies of A and B known at compile time (FAST), or chosen
// at run time.
template <typename T>
static int launch_any(const igemm::DenseA<false>& a, const BSrc& b,
                      const EpiArgs& e, int L, int splits, int split_k,
                      int* ws, unsigned* counters, cudaStream_t stream) {
  if (a.vec && b.mode == igemm::B_COPY16) {
    const igemm::DenseA<true> f{a.x, a.M, a.K, true, {nullptr, nullptr}};
    return launch<T, true>(f, b, e, L, splits, split_k, ws, counters,
                           stream);
  }
  return launch<T, false>(a, b, e, L, splits, split_k, ws, counters, stream);
}

// x [L, M, K] int8, w [L, K, N] int8, scale / bias0 [L, N] f32, bias
// [N] f32 or bf16 (bias_bf16) or null (one layer only), out [L, M, N]
// bf16 or f32. bm, stages, splits, split_k: the plan of
// ops/qmatmul.py:qmm_plan; ws: int32 [L, tiles, splits, 128, 128] and
// counters: L x tiles zeroed uint32 when splits > 1.
extern "C" int mixdq_qmatmul(const int8_t* x, const int8_t* w,
                             const float* scale, const float* bias0,
                             const void* bias, int bias_bf16, void* out,
                             int* ws, unsigned* counters, int L, int M,
                             int K, int N, int out_bf16, int bm, int stages,
                             int splits, int split_k, cudaStream_t stream) {
  if (!igemm::plan_ok(bm, stages, splits, split_k, K, ws, counters) ||
      L < 1 || (L > 1 && bias != nullptr) ||
      static_cast<long long>(L) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const igemm::DenseA<false> a{x, M, K, vec16(x, K), {nullptr, nullptr}};
  const BSrc b{w, N, igemm::b_mode(w, N)};
  const EpiArgs e{scale, bias0, bias, nullptr, nullptr, out, M, N, 1,
                  bias_bf16 != 0, false, false};
  return out_bf16 ? launch_any<__nv_bfloat16>(a, b, e, L, splits, split_k,
                                              ws, counters, stream)
                  : launch_any<float>(a, b, e, L, splits, split_k, ws,
                                      counters, stream);
}
