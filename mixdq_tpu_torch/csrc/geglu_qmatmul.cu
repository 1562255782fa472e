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
// and _geglu_lnout_kernel :489): one cooperative launch in grid-stride
// stages separated by grid-wide syncs: (LN-folded mode) LayerNorm + proj
// act-quantize of every row into a codes workspace; 64x64 GEGLU tiles
// (geglu_tile, on mma_s8.cuh's block) into an [M, H] workspace of
// ff.net.2's codes; the ff.net.2 GEMM with qmatmul's epilogue (bias0
// subtracted in f32 there), its bias and the residual (the raw input in
// LN-folded mode), in the model dtype. The TPU
// kernel sums net.2 over its H panels in an int32 scratch and pads H with
// zero w2 rows; here one net.2 tile sums the whole H, columns past H read
// as zero. Two launches would be simpler, but the JAX package runs one
// call per ff site. Bounds: at M = 1024 K = C = 640 H = 2560 the int8
// operations (10.1 GOP, ~5.1 us); at M = 256 K = C = 1280 H = 5120 the
// weight bytes (19.7 MB, ~5.9 us).

#include <cooperative_groups.h>

#include <algorithm>

#include "igemm_s8.cuh"

namespace cg = cooperative_groups;
using namespace mixdq;

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

// One 64x64 tile of ff.net.2's codes on mma_s8.cuh's block (only
// geglu_out_qmatmul's): rows [m0, m0 + 64), value columns [n0, n0 + 64)
// and their gate columns. Every thread of the block calls it; As, Bv and
// Bg are free again when it returns.
__device__ void geglu_tile(const GegluArgs& a, int m0, int n0, bool avec,
                           bool bvec, int8_t (*As)[LDS], int8_t (*Bv)[LDS],
                           int8_t (*Bg)[LDS]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int ldw = 2 * a.H;

  int accv[2][4][4] = {}, accg[2][4][4] = {};
  Chunk16 ra = load_a(a.x, a.M, a.K, m0, 0, tid, avec);
  Chunk16 rv = load_b(a.w, ldw, 0, a.H, a.K, 0, n0, tid, bvec);
  Chunk16 rg = load_b(a.w, ldw, a.H, a.H, a.K, 0, n0, tid, bvec);
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    store_a(As, ra, tid);
    store_b(Bv, rv, tid);
    store_b(Bg, rg, tid);
    __syncthreads();
    if (k0 + BK < a.K) {
      ra = load_a(a.x, a.M, a.K, m0, k0 + BK, tid, avec);
      rv = load_b(a.w, ldw, 0, a.H, a.K, k0 + BK, n0, tid, bvec);
      rg = load_b(a.w, ldw, a.H, a.H, a.K, k0 + BK, n0, tid, bvec);
    }
    warp_mma(As, Bv, wm, wn, lane, accv);
    warp_mma(As, Bg, wm, wn, lane, accg);
    __syncthreads();
  }

  for_each_acc(wm, wn, lane, accv, accg, [&](int r, int c, int av, int ag) {
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.H) return;
    const int ng = a.H + n;
    float v = __fmul_rn(__int2float_rn(av - __float2int_rz(a.bias0[n])),
                        a.scale[n]);
    float g = __fmul_rn(__int2float_rn(ag - __float2int_rz(a.bias0[ng])),
                        a.scale[ng]);
    if (a.bias) {
      v = __fadd_rn(v, a.bias[n]);
      g = __fadd_rn(g, a.bias[ng]);
    }
    const float y = __fmul_rn(v, gelu(g, a.gelu_tanh));
    a.out[static_cast<size_t>(m) * a.H + n] =
        quant_code(y, a.sinv, a.zp, a.lo, a.hi);
  });
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

// The tile at (blockIdx.y, blockIdx.x) over split blockIdx.z: mainloop,
// split-K reduction, GEGLU epilogue (igemm::run_tile's steps).
template <bool FAST>
__global__ void __launch_bounds__(igemm::NT, 2)
    geglu_kernel(igemm::DenseA<FAST> x, igemm::GegluB b, GegluArgs a,
                 int split_k, int* ws, unsigned* counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * igemm::BM, n0 = blockIdx.x * GEGLU_BN;
  const int k_begin = blockIdx.z * split_k;
  const int k_end = min(a.K, k_begin + split_k);
  const int mtiles = max(0, min(4, (a.M - m0 - wm + 15) / 16));
  const bool nlive = n0 + (wn >> 1) < a.H;
  int acc[4][4][4] = {};
  x.init(m0);
  igemm::mainloop<FAST, GEGLU_STAGES>(x, b, n0, k_begin, k_end, smem, wm,
                                      wn, mtiles, nlive, acc);
  if (gridDim.z > 1 &&
      !igemm::reduce_splits(ws, counters, blockIdx.y * gridDim.x + blockIdx.x,
                            blockIdx.z, gridDim.z, mtiles, nlive, acc))
    return;
  if (nlive) geglu_epilogue(a, m0, n0, wm, wn, mtiles, acc);
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
  GegluArgs g;  // x: the codes workspace or input; out: the [M, H] codes
  const T* x;   // raw input (LN-folded mode; also the residual) or null
  const float* gamma;
  const float* beta;
  float x_sinv, x_zp, x_lo, x_hi, eps;
  int ln, C;
  const int8_t* w2;  // [H, C]
  const float* s2;
  const float* b02;
  const float* b2;  // [C] or null
  const T* res;     // [M, C] or null (pre-coded mode)
  T* out;           // [M, C]
  bool avec, bvec, avec2, bvec2;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    geglu_out_kernel(const GegluOutArgs<T> a) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bv[BN][LDS];
  __shared__ __align__(16) int8_t Bg[BN][LDS];
  const int M = a.g.M, H = a.g.H;
  cg::grid_group grid = cg::this_grid();
  if (a.ln) {  // pre-LayerNorm + proj act-quantize, a warp per row
    ln_stage(a.x, a.gamma, a.beta, const_cast<int8_t*>(a.g.x), M, a.g.K,
             a.x_sinv, a.x_zp, a.x_lo, a.x_hi, a.eps);
    grid.sync();
  }
  const int nh = (H + BN - 1) / BN, tiles = (M + BM - 1) / BM * nh;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    geglu_tile(a.g, tile / nh * BM, tile % nh * BN, a.avec, a.bvec, As, Bv,
               Bg);
  grid.sync();
  // ff.net.2 + bias + residual
  out_stage<T>(As, Bv, a.g.out, M, H, a.avec2, a.w2, a.C, a.bvec2, a.s2,
               a.b02, a.b2, a.ln ? a.x : a.res, a.out);
}

template <typename T>
static int geglu_out(const GegluArgs& g, const void* x, const float* gamma,
                     const float* beta, float x_sinv, float x_zp, float x_lo,
                     float x_hi, float eps, int ln, int C, const int8_t* w2,
                     const float* s2, const float* b02, const float* b2,
                     const void* res, void* out, cudaStream_t stream) {
  GegluOutArgs<T> a{g, static_cast<const T*>(x), gamma, beta, x_sinv, x_zp,
                    x_lo, x_hi, eps, ln, C, w2, s2, b02, b2,
                    static_cast<const T*>(res), static_cast<T*>(out),
                    vec16(g.x, g.K), g.H % 16 == 0 && vec16(g.w, 2 * g.H),
                    vec16(g.out, g.H), vec16(w2, C)};
  const int tiles = std::max(tiles64(g.M, g.H), tiles64(g.M, C));
  const int grid = cooperative_grid<geglu_out_kernel<T>>(THREADS, 0, tiles);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(geglu_out_kernel<T>),
                              dim3(grid), dim3(THREADS), args, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixdq_geglu_out_qmatmul(
    const void* x, const float* gamma, const float* beta, int8_t* codes,
    const int8_t* w, const float* scale, const float* bias0,
    const float* bias, int8_t* h, const int8_t* w2, const float* s2,
    const float* b02, const float* b2, const void* res, void* out, int M,
    int K, int H, int C, int gelu_tanh, int is_bf16, int ln, float sinv,
    float zp, float lo, float hi, float x_sinv, float x_zp, float x_lo,
    float x_hi, float eps, cudaStream_t stream) {
  const GegluArgs g{codes, w, scale, bias0, bias, h, M, K, H, gelu_tanh,
                    sinv, zp, lo, hi};
  auto fn = is_bf16 ? geglu_out<__nv_bfloat16> : geglu_out<float>;
  return fn(g, x, gamma, beta, x_sinv, x_zp, x_lo, x_hi, eps, ln, C, w2, s2,
            b02, b2, res, out, stream);
}
