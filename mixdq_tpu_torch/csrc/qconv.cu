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
// matrix. Bound: int8 operations at large maps (conv 320->320 @ 64x64,
// 7.5 GOP, ~3.8 us at 1,979 TOP/s) and the weight bytes at small maps
// (conv 2560->1280 @ 16x16, 29.5 MB, ~8.8 us at 3.35 TB/s). This first
// version runs mma.sync tiles (mma_s8.cuh) without split-K, so the small
// maps fill only BM-row stripes of the card.

#include "mma_s8.cuh"

using namespace mixdq;

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias0;
  const float* bias;   // [K] or null
  const float* ebias;  // [B, K] or null
  const void* res;     // [B, P, Q, K] (out dtype) or null
  void* out;           // [B, P, Q, K]
  int B, H, W, C, K, kh, kw, stride, ph, pw, P, Q;
  int zp;
};

// 16 consecutive k of one pixel row of the implicit A matrix. `avec`:
// C % 16 == 0, so the 16 k share one tap and one aligned 16-byte load.
template <bool AVEC>
__device__ __forceinline__ Chunk16 load_a_conv(const ConvArgs& a, int kk,
                                               bool valid, int b, int ih0,
                                               int iw0, int Kdim) {
  Chunk16 u = fill16(0);
  if (!valid) return u;
  if (AVEC) {
    if (kk >= Kdim) return u;
    const int tap = kk / a.C, c = kk - tap * a.C;
    const int r = tap / a.kw, s = tap - r * a.kw;
    const int ih = ih0 + r, iw = iw0 + s;
    if (ih < 0 || ih >= a.H || iw < 0 || iw >= a.W) return fill16(a.zp);
    u.v = *reinterpret_cast<const int4*>(
        a.x + ((static_cast<size_t>(b) * a.H + ih) * a.W + iw) * a.C + c);
    return u;
  }
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int k = kk + i;
    if (k >= Kdim) break;
    const int tap = k / a.C, c = k - tap * a.C;
    const int r = tap / a.kw, s = tap - r * a.kw;
    const int ih = ih0 + r, iw = iw0 + s;
    u.s[i] = (ih < 0 || ih >= a.H || iw < 0 || iw >= a.W)
                 ? static_cast<int8_t>(a.zp)
                 : a.x[((static_cast<size_t>(b) * a.H + ih) * a.W + iw) *
                           a.C + c];
  }
  return u;
}

template <typename T, bool AVEC, bool BVEC>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const ConvArgs a) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bs[BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.B * a.P * a.Q, Kdim = a.kh * a.kw * a.C;

  // this thread's A row (one output pixel) is fixed for the whole K loop
  const int m = m0 + tid / 2;
  const bool valid = m < M;
  const int mm = valid ? m : 0;
  const int b = mm / (a.P * a.Q), pq = mm - b * a.P * a.Q;
  const int p = pq / a.Q, q = pq - p * a.Q;
  const int ih0 = p * a.stride - a.ph, iw0 = q * a.stride - a.pw;
  const int kc = (tid % 2) * 16;

  int acc[2][4][4] = {};
  Chunk16 ra = load_a_conv<AVEC>(a, kc, valid, b, ih0, iw0, Kdim);
  Chunk16 rb = load_b(a.w, a.K, 0, a.K, Kdim, 0, n0, tid, BVEC);
  for (int k0 = 0; k0 < Kdim; k0 += BK) {
    store_a(As, ra, tid);
    store_b(Bs, rb, tid);
    __syncthreads();
    if (k0 + BK < Kdim) {
      ra = load_a_conv<AVEC>(a, k0 + BK + kc, valid, b, ih0, iw0, Kdim);
      rb = load_b(a.w, a.K, 0, a.K, Kdim, k0 + BK, n0, tid, BVEC);
    }
    warp_mma(As, Bs, wm, wn, lane, acc);
    __syncthreads();
  }

  const int PQ = a.P * a.Q;
  for_each_acc(wm, wn, lane, acc, acc, [&](int r, int c, int v, int) {
    const int mo = m0 + r, n = n0 + c;
    if (mo >= M || n >= a.K) return;
    const size_t o = static_cast<size_t>(mo) * a.K + n;
    float y = __fmul_rn(__fsub_rn(__int2float_rn(v), a.bias0[n]), a.scale[n]);
    if (a.bias) y = __fadd_rn(y, a.bias[n]);
    if (a.ebias) y = __fadd_rn(y, a.ebias[(mo / PQ) * a.K + n]);
    if (a.res) y = __fadd_rn(y, to_f32(static_cast<const T*>(a.res)[o]));
    store_f32(static_cast<T*>(a.out) + o, y);
  });
}

template <typename T>
static void launch(const ConvArgs& a, bool avec, bool bvec, cudaStream_t st) {
  const int M = a.B * a.P * a.Q;
  const dim3 grid((M + BM - 1) / BM, (a.K + BN - 1) / BN);
  if (avec && bvec) qconv_kernel<T, true, true><<<grid, THREADS, 0, st>>>(a);
  else if (avec) qconv_kernel<T, true, false><<<grid, THREADS, 0, st>>>(a);
  else if (bvec) qconv_kernel<T, false, true><<<grid, THREADS, 0, st>>>(a);
  else qconv_kernel<T, false, false><<<grid, THREADS, 0, st>>>(a);
}

extern "C" int mixdq_qconv2d(const int8_t* x, const int8_t* w,
                             const float* scale, const float* bias0,
                             const float* bias, const float* ebias,
                             const void* res, void* out, int B, int H, int W,
                             int C, int K, int kh, int kw, int stride, int ph,
                             int pw, int zp, int out_bf16,
                             cudaStream_t stream) {
  ConvArgs a{x, w, scale, bias0, bias, ebias, res, out, B, H, W, C, K, kh, kw,
             stride, ph, pw, 0, 0, zp};
  a.P = (H + 2 * ph - kh) / stride + 1;
  a.Q = (W + 2 * pw - kw) / stride + 1;
  const bool avec = C % 16 == 0, bvec = K % 16 == 0;
  if (out_bf16) launch<__nv_bfloat16>(a, avec, bvec, stream);
  else launch<float>(a, avec, bvec, stream);
  return static_cast<int>(cudaGetLastError());
}
