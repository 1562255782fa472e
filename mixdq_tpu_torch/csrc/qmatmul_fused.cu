// W8A8 GEMMs with the activation quantize fused in: bf16 activations in,
// s8 codes formed inside the kernel, int8 mma.sync, int32 bias0 epilogue.
//
// Replace mixdq_tpu/ops/pallas_qmatmul.py:qmatmul_fused (pallas_call at
// :760, body _fused_kernel :135) and :qmatmul_fused2 (pallas_call :263,
// body _fused2_kernel :161). Both compute, for bf16 x [M, K] (the wrapper
// casts first, as the JAX wrappers do), s8 weights w [K, N] and f32 [N]
// scale / bias0:
//
//   codes = clip(rint(f32(x) * scale_inv) + zp_shifted, -128, 127)   s8
//   acc   = codes @ w                                                s32
//   out   = f32(acc - int32(bias0)) * scale          -> bf16 or f32 [M, N]
//
// bias0 is truncated to int32 and subtracted in int32, as the Pallas
// kernels do (qmatmul.cu subtracts in f32). K tails take zero codes
// against the zero weight rows load_b reads there, which add 0, where JAX
// pads x with zeros (code zp_shifted) against zero rows of w.
//
// qmatmul_fused keeps the TPU kernel's schedule: one 64x64 output tile
// per 128-thread block (mma_s8.cuh:gemm_tile_a) whose A loader reads the
// bf16 x tile (64 rows x 32 k, 4 KB) and quantizes it in registers on its
// way to shared memory. So every (m, n) tile quantizes its rows again at
// every k step, N / 64 times per element (20 times at N = 1280): the
// reason the TPU kernel ran 3x slower in the model (DESIGN_NOTES.md:120).
//
// qmatmul_fused2 quantizes once per M tile. A block owns RM = 32 rows
// (16 where K is too long for 32 rows of codes: above K = 7040), quantizes
// x[RM, K] once into s8 codes resident in dynamic shared memory (rows of
// K rounded up to 128, plus 16 bytes, so a warp's fragment loads hit 32
// distinct banks), then walks N tiles of 128 columns, streaming 32 k x
// 128 n weight tiles through shared memory into mma.sync, a warp per 32
// columns. At K = 5120 the codes take 160 KB of the 227 KB a block may
// have. With 32-row tiles M = 1024 gives only 32 M tiles for 132 SMs, so
// the N tiles of an M tile are split over as many blocks as fill the card
// once (at the blocks per SM that fit), and each of those quantizes its
// rows again (x is read again, from L2): more blocks in flight for more
// quantize work. Tuning that split is later work.
//
// Bound at M=1024 K=5120 N=1280 (ff.net.2 at SDXL 1024's 32x32 level):
// 13.4 G int8 operations, ~6.8 us at 1,979 TOP/s; 19.7 MB in and out,
// ~5.9 us at 3.35 TB/s.

#include "mma_s8.cuh"

using namespace mixdq;

typedef __nv_bfloat16 bf16;

constexpr int BN2 = 128;          // columns per N tile of qmatmul_fused2
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have

union Codes8 {
  uint2 v;
  int8_t s[8];
};

// The codes of the 8 bf16 values at src, of which the first n are in
// range (zero codes past them), with one 16-byte load when vec and n >= 8.
__device__ __forceinline__ uint2 quant8(const bf16* src, int n, bool vec,
                                        float sinv, float zp) {
  Codes8 c;
  c.v = make_uint2(0u, 0u);
  if (vec && n >= 8) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c.s[j] = quant_code(__bfloat162float(e[j]), sinv, zp, -128.f, 127.f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n)
        c.s[j] = quant_code(__bfloat162float(src[j]), sinv, zp, -128.f,
                            127.f);
  }
  return c.v;
}

// load_a's share of a 64-row A tile (row m0 + tid / 2, 16 k from
// k0 + (tid % 2) * 16), quantized from bf16 x [M, K]; rows >= M and
// k >= K give zero codes. vec: K % 8 == 0 and x 16-byte aligned.
__device__ __forceinline__ Chunk16 quant_share(const bf16* __restrict__ x,
                                               int M, int K, int m0, int k0,
                                               int tid, bool vec, float sinv,
                                               float zp) {
  const int m = m0 + tid / 2, k = k0 + (tid % 2) * 16;
  Chunk16 u = fill16(0);
  if (m >= M) return u;
  const bf16* src = x + static_cast<size_t>(m) * K + k;
  const uint2 lo = quant8(src, K - k, vec, sinv, zp);
  const uint2 hi = quant8(src + 8, K - k - 8, vec, sinv, zp);
  u.v = make_int4(static_cast<int>(lo.x), static_cast<int>(lo.y),
                  static_cast<int>(hi.x), static_cast<int>(hi.y));
  return u;
}

// out[m, n] = f32(acc - int32(bias0[n])) * scale[n], in range only.
template <typename T>
__device__ __forceinline__ void store_out(T* out, const float* scale,
                                          const float* bias0, int M, int N,
                                          int m, int n, int acc) {
  if (m >= M || n >= N) return;
  const int a = acc - __float2int_rz(bias0[n]);
  store_f32(out + static_cast<size_t>(m) * N + n,
            __fmul_rn(__int2float_rn(a), scale[n]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    qmatmul_fused_kernel(const bf16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias0, T* __restrict__ out,
                         int M, int K, int N, float sinv, float zp, bool xvec,
                         bool bvec) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bs[BN][LDS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  gemm_tile_a(
      [=](int k0) {
        return quant_share(x, M, K, m0, k0, threadIdx.x, xvec, sinv, zp);
      },
      K, m0, w, N, n0, bvec, As, Bs, [&](int m, int n, int acc) {
        store_out(out, scale, bias0, M, N, m, n, acc);
      });
}

// MI m16 fragments per warp: RM = 16 MI rows per block. Dynamic shared
// memory: the weight tile Bs [BN2][LDS], then the codes [RM][ldc].
template <typename T, int MI>
__global__ void __launch_bounds__(THREADS)
    qmatmul_fused2_kernel(const bf16* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias0,
                          T* __restrict__ out, int M, int K, int N, int ldc,
                          float sinv, float zp, bool xvec, bool bvec) {
  constexpr int RM = 16 * MI;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t(*Bs)[LDS] = reinterpret_cast<int8_t(*)[LDS]>(smem);
  int8_t* codes = smem + BN2 * LDS;
  const int tid = threadIdx.x, lane = tid & 31, wn = (tid >> 5) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * RM, per_row = ldc / 8;
  // the block's rows, quantized once, 8 codes per step
  for (int i = tid; i < RM * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    uint2 v = make_uint2(0u, 0u);
    if (m0 + r < M)
      v = quant8(x + static_cast<size_t>(m0 + r) * K + c, K - c, xvec, sinv,
                 zp);
    *reinterpret_cast<uint2*>(codes + r * ldc + c) = v;
  }
  __syncthreads();
  for (int n0 = blockIdx.y * BN2; n0 < N; n0 += gridDim.y * BN2) {
    int acc[MI][4][4] = {};
    Chunk16 rb0 = load_b(w, N, 0, N, K, 0, n0, tid, bvec);
    Chunk16 rb1 = load_b(w, N, 0, N, K, 0, n0 + 64, tid, bvec);
    for (int k0 = 0; k0 < K; k0 += BK) {
      store_b(Bs, rb0, tid);
      store_b(Bs + 64, rb1, tid);
      __syncthreads();
      if (k0 + BK < K) {
        rb0 = load_b(w, N, 0, N, K, k0 + BK, n0, tid, bvec);
        rb1 = load_b(w, N, 0, N, K, k0 + BK, n0 + 64, tid, bvec);
      }
      int a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* r0 = codes + (mi * 16 + g) * ldc + k0 + t * 4;
        const int8_t* r1 = r0 + 8 * ldc;
        a[mi][0] = *reinterpret_cast<const int*>(r0);
        a[mi][1] = *reinterpret_cast<const int*>(r1);
        a[mi][2] = *reinterpret_cast<const int*>(r0 + 16);
        a[mi][3] = *reinterpret_cast<const int*>(r1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = Bs[wn + ni * 8 + g];
        const int b[2] = {*reinterpret_cast<const int*>(c0 + t * 4),
                          *reinterpret_cast<const int*>(c0 + 16 + t * 4)};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8(acc[mi][ni], a[mi], b);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          store_out(out, scale, bias0, M, N, m0 + mi * 16 + g + (r >> 1) * 8,
                    n0 + wn + ni * 8 + t * 2 + (r & 1), acc[mi][ni][r]);
  }
}

template <typename T, int MI>
static int launch_fused2(const bf16* x, const int8_t* w, const float* scale,
                         const float* bias0, T* out, int M, int K, int N,
                         int ldc, float sinv, float zp, bool xvec, bool bvec,
                         cudaStream_t stream) {
  const int smem = BN2 * LDS + 16 * MI * ldc;
  cudaError_t e = cudaFuncSetAttribute(
      qmatmul_fused2_kernel<T, MI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qmatmul_fused2_kernel<T, MI>, THREADS, smem);
  const int mt = (M + 16 * MI - 1) / (16 * MI), nt = (N + BN2 - 1) / BN2;
  const int split = max(1, min(nt, sms * per_sm / max(mt, 1)));
  qmatmul_fused2_kernel<T, MI><<<dim3(mt, split), THREADS, smem, stream>>>(
      x, w, scale, bias0, out, M, K, N, ldc, sinv, zp, xvec, bvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int fused2(const bf16* x, const int8_t* w, const float* scale,
                  const float* bias0, T* out, int M, int K, int N, float sinv,
                  float zp, bool xvec, bool bvec, cudaStream_t stream) {
  const int ldc = (K + 127) / 128 * 128 + 16;
  if (BN2 * LDS + 32 * ldc <= MAX_SMEM)
    return launch_fused2<T, 2>(x, w, scale, bias0, out, M, K, N, ldc, sinv,
                               zp, xvec, bvec, stream);
  if (BN2 * LDS + 16 * ldc <= MAX_SMEM)
    return launch_fused2<T, 1>(x, w, scale, bias0, out, M, K, N, ldc, sinv,
                               zp, xvec, bvec, stream);
  return static_cast<int>(cudaErrorInvalidValue);  // K above 14,080
}

extern "C" int mixdq_qmatmul_fused(const void* x, const int8_t* w,
                                   const float* scale, const float* bias0,
                                   void* out, int M, int K, int N, float sinv,
                                   float zp, int out_bf16,
                                   cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bvec = vec16(w, N);
  if (out_bf16)
    qmatmul_fused_kernel<bf16><<<grid, THREADS, 0, stream>>>(
        xb, w, scale, bias0, static_cast<bf16*>(out), M, K, N, sinv, zp, xvec,
        bvec);
  else
    qmatmul_fused_kernel<float><<<grid, THREADS, 0, stream>>>(
        xb, w, scale, bias0, static_cast<float*>(out), M, K, N, sinv, zp,
        xvec, bvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixdq_qmatmul_fused2(const void* x, const int8_t* w,
                                    const float* scale, const float* bias0,
                                    void* out, int M, int K, int N,
                                    float sinv, float zp, int out_bf16,
                                    cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bvec = vec16(w, N);
  return out_bf16 ? fused2(xb, w, scale, bias0, static_cast<bf16*>(out), M,
                           K, N, sinv, zp, xvec, bvec, stream)
                  : fused2(xb, w, scale, bias0, static_cast<float*>(out), M,
                           K, N, sinv, zp, xvec, bvec, stream);
}
