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
// (pallas_qmatmul.py:306-307). Each block computes the value and the gate
// tile of the same 64 output columns, so the [M, 2H] projection output
// never reaches device memory. Bound: int8 operations at M = 1024
// (6.7 GOP, ~3.4 us at 1,979 TOP/s) and the weight bytes at M = 256
// (13.1 MB, ~3.9 us at 3.35 TB/s).
//
// geglu_out_qmatmul, the whole feed-forward (replaces
// :geglu_out_qmatmul, pallas_call at :702, bodies _geglu_out_kernel :459
// and _geglu_lnout_kernel :489): one cooperative launch in grid-stride
// stages separated by grid-wide syncs: (LN-folded mode) LayerNorm + proj
// act-quantize of every row into a codes workspace; the GEGLU tiles above
// into an [M, H] workspace of ff.net.2's codes; the ff.net.2 GEMM with
// qmatmul's epilogue (bias0 subtracted in f32 there), its bias and the
// residual (the raw input in LN-folded mode), in the model dtype. The TPU
// kernel sums net.2 over its H panels in an int32 scratch and pads H with
// zero w2 rows; here one net.2 tile sums the whole H, columns past H read
// as zero. Two launches would be simpler, but the JAX package runs one
// call per ff site. Bounds: at M = 1024 K = C = 640 H = 2560 the int8
// operations (10.1 GOP, ~5.1 us); at M = 256 K = C = 1280 H = 5120 the
// weight bytes (19.7 MB, ~5.9 us).

#include <cooperative_groups.h>

#include <algorithm>

#include "mma_s8.cuh"

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

// One 64x64 tile of ff.net.2's codes: rows [m0, m0 + 64), value columns
// [n0, n0 + 64) and their gate columns. Every thread of the block calls
// it; As, Bv and Bg are free again when it returns.
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

__global__ void __launch_bounds__(THREADS)
    geglu_kernel(const GegluArgs a, bool avec, bool bvec) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bv[BN][LDS];
  __shared__ __align__(16) int8_t Bg[BN][LDS];
  geglu_tile(a, blockIdx.x * BM, blockIdx.y * BN, avec, bvec, As, Bv, Bg);
}

extern "C" int mixdq_geglu_qmatmul(const int8_t* x, const int8_t* w,
                                   const float* scale, const float* bias0,
                                   const float* bias, int8_t* out, int M,
                                   int K, int H, int gelu_tanh, float sinv,
                                   float zp, float lo, float hi,
                                   cudaStream_t stream) {
  const GegluArgs a{x, w, scale, bias0, bias, out, M, K, H, gelu_tanh,
                    sinv, zp, lo, hi};
  const dim3 grid((M + BM - 1) / BM, (H + BN - 1) / BN);
  geglu_kernel<<<grid, THREADS, 0, stream>>>(a, K % 16 == 0, H % 16 == 0);
  return static_cast<int>(cudaGetLastError());
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
  const int grid = cooperative_grid(geglu_out_kernel<T>, tiles);
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
