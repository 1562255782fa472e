// W8A8 GEGLU projection with fused gate and consumer act-quantize.
//
// Replaces mixdq_tpu/ops/pallas_qmatmul.py:geglu_qmatmul (pallas_call at
// :438). For codes x [M, K] and weights w [K, 2H] (value columns [0, H),
// gate columns [H, 2H)):
//
//   v = (acc_v - int(bias0_v)) * scale_v (+ bias_v)
//   g = (acc_g - int(bias0_g)) * scale_g (+ bias_g)
//   out = quantize(v * gelu(g))          -> s8 [M, H]
//
// bias0 is cast to int32 before the subtraction, as the reference does
// (pallas_qmatmul.py:306-307). The [M, 2H] projection never reaches
// device memory. Bound on an H100 SXM (1,979 TOP/s int8, 3.35 TB/s): the
// int8 operations at M = 1024 K = 640 H = 2560 (6.7 GOP, ~3.4 us) and
// the weight bytes at M = 256 K = 1280 H = 5120 (13.1 MB, ~3.9 us).
//
// Design: the mainloop of igemm_s8.cuh (cp.async ring of 128-byte k
// steps, 128 x 128 tiles of 8 warps, split-K reduced by each tile's last
// block in the same launch), on a 2-stage ring with two blocks an SM
// (on an H100 faster at the shapes below than one block an SM on the
// 4-stage ring; a 3-stage ring spilled), with the interleaving B loader
// igemm::GegluB: a tile's 128 weight columns are 64 output columns'
// values and gates, each warp slab 16 values then their 16 gates, so
// thread (g, t) holds values for t < 2 and the same columns' gates in
// lane t ^ 2. The epilogue dequantizes its own columns, trades half of
// them with that lane (the value lane keeps rows g, the gate lane rows
// g + 8), and stores 8 codes a row in one 8-byte store. The plan is
// ops/qmatmul.py:geglu_plan, qmm_plan over the 2H weight columns and the
// 2 x 132 blocks an H100 holds. Waves of 264 blocks (tiles of 128 rows x
// 64 output columns; no split at these):
//   M=256  K=1280 H=5120   160 tiles, 1 wave (61% full)
//   M=1024 K=640  H=2560   320 tiles, 2 waves (the second 21% full)
//   M=1024 K=1280 H=5120   640 tiles, 3 waves (the third 42% full)
//   M=4096 K=640  H=2560  1280 tiles, 5 waves (the fifth 85% full)
// On an H100 every split of these was slower (a block's ring fill,
// epilogue and partial tile outweigh a shorter last wave); at M = 1 and
// 77 (80 tiles) three splits were faster than none.

// geglu_out_qmatmul, the whole feed-forward (replaces
// :geglu_out_qmatmul, pallas_call at :702, bodies _geglu_out_kernel :459
// and _geglu_lnout_kernel :489): one cooperative launch (the JAX package
// runs one call per ff site) in three grid-stride stages separated by
// grid-wide syncs, all in the same dynamic shared memory:
//   1. LN-folded mode: LayerNorm + proj act-quantize of every row into a
//      codes workspace, a warp a row on common.cuh:ln_rows (ln_quantize's
//      rows), gamma, beta and each warp's row in the ring's memory;
//   2. the GEGLU items (tile, split) of geglu_qmatmul's plan on the same
//      mainloop, B loader and epilogue as geglu_kernel (geglu_item), into
//      an [M, H] workspace of ff.net.2's codes;
//   3. ff.net.2: igemm::run_tile over the (tile, split) items of
//      qmm_plan(M, H, C) on the same ring, A the [M, H] codes, with
//      qmatmul's epilogue (bias0 subtracted in f32), ff.net.2's bias and
//      the residual (the raw input in LN-folded mode), in the model dtype.
// The two GEMM stages share one split workspace and its arrival counters,
// one stage at a time (each tile's last block resets its counter). One
// block an SM on the 4-stage ring (246-254 registers, no spills); two
// blocks an SM on geglu_kernel's 2-stage ring spilled ~200 bytes a
// thread at its 128 registers (PERF.md has its times). The TPU kernel
// sums net.2 over its H panels in an int32 scratch and pads H with zero
// w2 rows; here a ragged H reads as zero (the A loader stops at H). Plan: ops/qmatmul.py:geglu_out_plan (both stages' plans, the grid:
// at most the blocks the card holds at once). Waves on an H100's 132 SMs,
// one block an SM (GEGLU tiles; ff.net.2 tiles x splits):
//   M=256  C=1280 H=5120   160, 2 waves (the second 21% full); 20 x 6
//   M=1024 C=640  H=2560   320, 3 waves (the third 42% full); 40 x 3
// Bounds: at M = 1024 K = C = 640 H = 2560 the int8 operations (10.1 GOP,
// ~5.1 us); at M = 256 K = C = 1280 H = 5120 the weight bytes (19.7 MB,
// ~5.9 us).

#include <cooperative_groups.h>

#include <algorithm>

#include "igemm_s8.cuh"

namespace cg = cooperative_groups;
using namespace mixdq;
using igemm::BSrc;
using igemm::EpiArgs;

struct GegluArgs {
  const int8_t* x;  // [M, K]
  const int8_t* w;  // [K, 2H]
  const float* scale;
  const float* bias0;
  const float* bias;  // [2H] or null
  int8_t* out;        // [M, H]
  int M, K, H, gelu_tanh;
  float sinv, zp, lo, hi;
};

// jax.nn.gelu, step by step: tanh form x * (0.5 * (1 + tanh(c * (x +
// 0.044715 x^3)))), exact form (0.5 * x) * erfc(-x * sqrt(1/2)).
__device__ __forceinline__ float gelu(float x, int tanh_form) {
  if (tanh_form) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float inner =
        __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner)));
    return __fmul_rn(x, cdf);
  }
  return __fmul_rn(__fmul_rn(0.5f, x),
                   erfcf(__fmul_rn(-x, 0.7071067811865476f)));
}

// The GEGLU epilogue of the tile at (m0, n0) (n0: its first output
// column) from the accumulators of thread (g, t) of the warp at (wm, wn):
// 8 output columns nb .. nb + 7, values for t < 2, gates for t >= 2. Each
// element's steps as the plain version's; after the exchange the value
// lane computes rows g, the gate lane rows g + 8.
__device__ __forceinline__ void geglu_epilogue(const GegluArgs& a, int m0,
                                               int n0, int wm, int wn,
                                               int mtiles,
                                               const int (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool gate = t >= 2;
  const int nb = n0 + (wn >> 1) + 8 * (t & 1);
  const int ncols = min(8, a.H - nb);
  const int col = gate ? a.H + nb : nb;  // of scale, bias0, bias
  float sc[8], bi[8];
  int ib0[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = j < ncols ? col + j : 0;
    sc[j] = a.scale[n];
    ib0[j] = __float2int_rz(a.bias0[n]);
    bi[j] = a.bias ? a.bias[n] : 0.f;
  }
  const bool vec = ncols == 8 && a.H % 8 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi >= mtiles) continue;
    uint32_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = j < 4 ? acc[mi][j][2 * h] : acc[mi][j - 4][2 * h + 1];
        d[h] = __fmul_rn(__int2float_rn(s - ib0[j]), sc[j]);
        if (a.bias) d[h] = __fadd_rn(d[h], bi[j]);
      }
      const float other = __shfl_xor_sync(0xffffffffu, gate ? d[0] : d[1], 2);
      const float v = gate ? other : d[0], gg = gate ? d[1] : other;
      q[j] = static_cast<uint32_t>(quant_code(
          __fmul_rn(v, gelu(gg, a.gelu_tanh)), a.sinv, a.zp, a.lo, a.hi));
    }
    const int m = m0 + wm + mi * 16 + g + (gate ? 8 : 0);
    if (m >= a.M || ncols <= 0) continue;
    int8_t* o = a.out + static_cast<size_t>(m) * a.H + nb;
    if (vec) {
      *reinterpret_cast<uint2*>(o) = make_uint2(
          __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                      __byte_perm(q[2], q[3], 0x0040), 0x5410),
          __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                      __byte_perm(q[6], q[7], 0x0040), 0x5410));
    } else {
      for (int j = 0; j < ncols; ++j) o[j] = static_cast<int8_t>(q[j]);
    }
  }
}

// Output columns of a tile: its 128 weight columns are their values and
// gates.
constexpr int GEGLU_BN = igemm::BN / 2;
// Ring stages: two blocks an SM (64 KB of ring and at most 128 registers
// a thread each), so that one block's ring fill and epilogue overlap the
// other's products.
constexpr int GEGLU_STAGES = 2;

// The GEGLU tile at rows m0.., output columns n0.. (`tile` its split-K
// counter) over split `split` of `splits`: mainloop on an NST-stage ring,
// split-K reduction, GEGLU epilogue (igemm::run_tile's steps). Every
// thread of the block calls it.
template <bool FAST, int NST>
__device__ __forceinline__ void geglu_item(igemm::DenseA<FAST>& x,
                                           const igemm::GegluB& b,
                                           const GegluArgs& a, int m0,
                                           int n0, int tile, int split,
                                           int splits, int split_k, int* ws,
                                           unsigned* counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int k_begin = split * split_k;
  const int k_end = min(a.K, k_begin + split_k);
  const int mtiles = max(0, min(4, (a.M - m0 - wm + 15) / 16));
  const bool nlive = n0 + (wn >> 1) < a.H;
  int acc[4][4][4] = {};
  x.init(m0);
  igemm::mainloop<FAST, NST>(x, b, n0, k_begin, k_end, smem, wm, wn, mtiles,
                             nlive, acc);
  if (splits > 1 && !igemm::reduce_splits(ws, counters, tile, split, splits,
                                          mtiles, nlive, acc))
    return;
  if (nlive) geglu_epilogue(a, m0, n0, wm, wn, mtiles, acc);
}

// The tile at (blockIdx.y, blockIdx.x) over split blockIdx.z.
template <bool FAST>
__global__ void __launch_bounds__(igemm::NT, 2)
    geglu_kernel(igemm::DenseA<FAST> x, igemm::GegluB b, GegluArgs a,
                 int split_k, int* ws, unsigned* counters) {
  geglu_item<FAST, GEGLU_STAGES>(
      x, b, a, blockIdx.y * igemm::BM, blockIdx.x * GEGLU_BN,
      blockIdx.y * gridDim.x + blockIdx.x, blockIdx.z, gridDim.z, split_k,
      ws, counters);
}

template <bool FAST>
static int geglu_launch(const igemm::DenseA<FAST>& x, const igemm::GegluB& b,
                        const GegluArgs& a, int splits, int split_k, int* ws,
                        unsigned* counters, cudaStream_t stream) {
  constexpr int smem = GEGLU_STAGES * igemm::STAGE;
  static const cudaError_t attrs = igemm::set_smem(geglu_kernel<FAST>, smem);
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((a.H + GEGLU_BN - 1) / GEGLU_BN,
                  (a.M + igemm::BM - 1) / igemm::BM, splits);
  geglu_kernel<FAST><<<grid, igemm::NT, smem, stream>>>(x, b, a, split_k, ws,
                                                        counters);
  return static_cast<int>(cudaGetLastError());
}

// bm, stages, splits, split_k: the plan of ops/qmatmul.py:geglu_plan; ws:
// int32 [tiles, splits, 128, 128] and counters: tiles zeroed uint32 when
// splits > 1.
extern "C" int mixdq_geglu_qmatmul(const int8_t* x, const int8_t* w,
                                   const float* scale, const float* bias0,
                                   const float* bias, int8_t* out, int* ws,
                                   unsigned* counters, int M, int K, int H,
                                   int gelu_tanh, float sinv, float zp,
                                   float lo, float hi, int bm, int stages,
                                   int splits, int split_k,
                                   cudaStream_t stream) {
  if (!igemm::plan_ok(bm, stages, splits, split_k, K, ws, counters,
                      GEGLU_STAGES))
    return static_cast<int>(cudaErrorInvalidValue);
  const GegluArgs a{x, w, scale, bias0, bias, out, M, K, H, gelu_tanh,
                    sinv, zp, lo, hi};
  const igemm::DenseA<false> xa{x, M, K, vec16(x, K), {nullptr, nullptr}};
  const igemm::GegluB b{w, H, igemm::b_mode(w, H)};
  if (xa.vec && b.mode == igemm::B_COPY16) {
    const igemm::DenseA<true> f{x, M, K, true, {nullptr, nullptr}};
    return geglu_launch<true>(f, b, a, splits, split_k, ws, counters, stream);
  }
  return geglu_launch<false>(xa, b, a, splits, split_k, ws, counters, stream);
}

// ---------------------------------------------------------------------------
// geglu_out_qmatmul
// ---------------------------------------------------------------------------

template <typename T>
struct GegluOutArgs {
  GegluArgs g;  // x: the proj codes [M, K] (written by stage 1 in LN-folded
                // mode); out: ff.net.2's codes [M, H]
  const T* x;   // raw input [M, K] (LN-folded mode; also the residual)
  const float* gamma;
  const float* beta;
  float x_sinv, x_zp, x_lo, x_hi, eps;
  int ln;
  bool ln_vec;  // stage 1 on shared-memory rows (ln_row_vec, they fit)
  bool xvec;    // the proj codes' 16-byte copies (vec16)
  bool hvec;    // ff.net.2's codes' 16-byte copies
  igemm::GegluB b;  // w [K, 2H]
  BSrc w2;          // [H, C]
  EpiArgs e2;       // ff.net.2's epilogue: out [M, C]
  int g_splits, g_split_k, o_splits, o_split_k;
  int* ws;
  unsigned* counters;
};

template <typename T, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    geglu_out_kernel(const GegluOutArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = a.g.M, warps = igemm::NT / 32;
  if (a.ln) {  // 1. LayerNorm + proj act-quantize, a warp a row
    ln_rows(a.x, a.gamma, a.beta, const_cast<int8_t*>(a.g.x), M, a.g.K,
            a.x_sinv, a.x_zp, a.x_lo, a.x_hi, a.eps, a.ln_vec, smem,
            blockIdx.x * warps + threadIdx.x / 32, gridDim.x * warps);
    grid.sync();
  }
  // 2. GEGLU into ff.net.2's codes
  const int gn = (a.g.H + GEGLU_BN - 1) / GEGLU_BN;
  const int gtiles = (M + igemm::BM - 1) / igemm::BM * gn;
  igemm::DenseA<FAST> x{a.g.x, M, a.g.K, a.xvec, {nullptr, nullptr}};
  for (int item = blockIdx.x; item < gtiles * a.g_splits;
       item += gridDim.x) {
    const int tile = item % gtiles, split = item / gtiles;
    __syncthreads();  // every warp is done with the shared memory
    geglu_item<FAST, igemm::STAGES>(x, a.b, a.g, tile / gn * igemm::BM,
                                    tile % gn * GEGLU_BN, tile, split,
                                    a.g_splits, a.g_split_k, a.ws,
                                    a.counters);
  }
  grid.sync();
  // 3. ff.net.2 + bias + residual
  const int nt = (a.e2.N + igemm::BN - 1) / igemm::BN;
  const int tiles = (M + igemm::BM - 1) / igemm::BM * nt;
  igemm::DenseA<FAST> h{a.g.out, M, a.g.H, a.hvec, {nullptr, nullptr}};
  for (int item = blockIdx.x; item < tiles * a.o_splits; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int m0 = tile / nt * igemm::BM, n0 = tile % nt * igemm::BN;
    __syncthreads();
    h.init(m0);
    igemm::run_tile<T, FAST, false>(h, a.w2, a.e2, a.g.H, m0, n0, tile,
                                    split, a.o_splits, a.o_split_k, a.ws,
                                    a.counters);
  }
}

// Each instantiation's ring, set once.
template <typename T, bool FAST>
static cudaError_t geglu_out_attrs() {
  static const cudaError_t err =
      igemm::set_smem(geglu_out_kernel<T, FAST>, igemm::SMEM);
  return err;
}

template <typename T, bool FAST>
static int geglu_out_launch(const GegluOutArgs<T>& a, int grid,
                            cudaStream_t stream) {
  const cudaError_t attrs = geglu_out_attrs<T, FAST>();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  void* args[] = {const_cast<GegluOutArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(geglu_out_kernel<T, FAST>), dim3(grid),
      dim3(igemm::NT), args, igemm::SMEM, stream));
}

template <typename T>
static int geglu_out(const GegluArgs& g, const void* x, const float* gamma,
                     const float* beta, float x_sinv, float x_zp, float x_lo,
                     float x_hi, float eps, int ln, int C, const int8_t* w2,
                     const float* s2, const float* b02, const float* b2,
                     const void* res, void* out, int g_splits, int g_split_k, int o_splits, int o_split_k, int* ws,
                     unsigned* counters, int grid, cudaStream_t stream) {
  const void* r = ln ? x : res;
  const GegluOutArgs<T> a{
      g, static_cast<const T*>(x), gamma, beta, x_sinv, x_zp, x_lo, x_hi,
      eps, ln,
      ln && ln_row_vec(x, gamma, beta, g.x, g.K) &&
          ln_smem_bytes(g.K, igemm::NT / 32, sizeof(T)) <= igemm::SMEM,
      vec16(g.x, g.K), vec16(g.out, g.H),
      igemm::GegluB{g.w, g.H, igemm::b_mode(g.w, g.H)},
      BSrc{w2, C, igemm::b_mode(w2, C)},
      EpiArgs{s2, b02, b2, nullptr, r, out, g.M, C, 1, false, false,
              r != nullptr && reinterpret_cast<uintptr_t>(r) % 16 == 0},
      g_splits, g_split_k, o_splits, o_split_k, ws, counters};
  // the 16-byte copies known at compile time (FAST) where both GEMM
  // stages take them; else the run-time copy modes
  if (a.xvec && a.b.mode == igemm::B_COPY16 && a.hvec &&
      a.w2.mode == igemm::B_COPY16)
    return geglu_out_launch<T, true>(a, grid, stream);
  return geglu_out_launch<T, false>(a, grid, stream);
}

// x [M, K]: the raw input in the model dtype (LN-folded mode: ln, gamma /
// beta f32 [K], the proj act quantizer x_*; also the residual) or null;
// codes [M, K]: the proj codes (written in LN-folded mode); w [K, 2H],
// scale / bias0 / bias [2H] (bias f32 or null), the ff.net.2 act
// quantizer sinv / zp / lo / hi; h [M, H]: ff.net.2's codes; w2 [H, C],
// s2 / b02 [C], b2 [C] f32 or null, res [M, C] or null (pre-coded mode),
// out [M, C] bf16 (is_bf16) or f32. bm, stages, g_* and o_*: the GEGLU and
// ff.net.2 plans of ops/qmatmul.py:geglu_out_plan (both on the 4-stage
// ring); ws / counters: their shared int32 workspace and zeroed
// counters (split plans); grid: the plan's, at most the blocks the card
// holds at once (mixdq_geglu_out_per_sm).
extern "C" int mixdq_geglu_out_qmatmul(
    const void* x, const float* gamma, const float* beta, int8_t* codes,
    const int8_t* w, const float* scale, const float* bias0,
    const float* bias, int8_t* h, const int8_t* w2, const float* s2,
    const float* b02, const float* b2, const void* res, void* out, int* ws,
    unsigned* counters, int M, int K, int H, int C, int gelu_tanh,
    int is_bf16, int ln, float sinv, float zp, float lo, float hi,
    float x_sinv, float x_zp, float x_lo, float x_hi, float eps, int bm,
    int stages, int g_splits, int g_split_k, int o_splits, int o_split_k,
    int grid, cudaStream_t stream) {
  if (!igemm::plan_ok(bm, stages, g_splits, g_split_k, K, ws, counters) ||
      !igemm::plan_ok(bm, stages, o_splits, o_split_k, H, ws, counters) ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GegluArgs g{codes, w, scale, bias0, bias, h, M, K, H, gelu_tanh,
                    sinv, zp, lo, hi};
  auto fn = is_bf16 ? geglu_out<__nv_bfloat16> : geglu_out<float>;
  return fn(g, x, gamma, beta, x_sinv, x_zp, x_lo, x_hi, eps, ln, C, w2, s2,
            b02, b2, res, out, g_splits, g_split_k, o_splits,
            o_split_k, ws, counters, grid, stream);
}

// Blocks of one geglu_out_kernel instantiation an SM holds at once.
template <typename T, bool FAST>
static int geglu_out_fit() {
  int n = 0;
  if (geglu_out_attrs<T, FAST>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, geglu_out_kernel<T, FAST>, igemm::NT, igemm::SMEM) !=
          cudaSuccess)
    return 0;
  return n;
}

// Blocks of geglu_out_qmatmul's kernels one SM holds at once (the least
// over their instantiations); 0 on an error.
extern "C" int mixdq_geglu_out_per_sm() {
  return std::min(
      std::min(geglu_out_fit<__nv_bfloat16, true>(),
               geglu_out_fit<__nv_bfloat16, false>()),
      std::min(geglu_out_fit<float, true>(), geglu_out_fit<float, false>()));
}
