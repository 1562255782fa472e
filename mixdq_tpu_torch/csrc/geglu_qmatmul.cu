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

#include "mma_s8.cuh"

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

__global__ void __launch_bounds__(THREADS)
    geglu_kernel(const GegluArgs a, bool avec, bool bvec) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bv[BN][LDS];
  __shared__ __align__(16) int8_t Bg[BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
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
