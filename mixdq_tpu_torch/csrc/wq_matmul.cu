// Weight-only GEMMs of the weight-only deploys: bf16 activations times
// int8 weight codes (wq_matmul) or halves-packed int4 codes (wq4_matmul),
// the weight tile dequantized in shared memory.
//
// Replaces mixdq_tpu/ops/pallas_wq_matmul.py:wq4_matmul (pallas_call at
// :133) and :wq_matmul (:208). For x [M, K] (bf16) and per-column scales
// s [N], both compute
//
//   out[m, n] = sum_k x[m, k] * bf16(bf16(code[k, n]) * bf16(s[n]))
//               (+ bias[n])                     -> bf16 or f32 [M, N]
//
// with each product exact in f32 (bf16 x bf16) and an f32 sum. The weight
// is dequantized as the TPU kernel does it (pallas_wq_matmul.py:39,
// :80-87): the code times the bf16 scale, rounded to bf16 before the
// product; the code times the scale is exact in f32, so one round to
// nearest even gives that bf16. wq4: the packed byte at (k, n) holds
// code(k, n) + 8 in its low nibble and code(k + K/2, n) + 8 in its high
// nibble, so one packed tile of K/2 rows feeds two products: x[:, :K/2]
// with the low nibbles and x[:, K/2:] with the high ones.
//
// One block of 128 threads owns a 64x64 output tile and loops over the
// whole K (no split-K, so no cross-block sum). Per step of 64 weight rows
// it loads the x tile(s) and the weight codes into registers (the next
// step's loads are issued before this step's products), stores x to shared
// memory as is and the weight dequantized to bf16, k-major, and runs bf16
// mma.sync m16n8k16 on 2x2 warps of 32x32 (B fragments by ldmatrix.trans).
// Rows m >= M, columns n >= N and depths k >= K read as zero: neither
// operand is padded or copied. No bf16 copy of the weight leaves shared
// memory.

#include "attn_mma.cuh"

using namespace mixdq;

namespace {

constexpr int TM = 64, TN = 64, TK = 64, NT = 128;
constexpr int LA = TK + 8;  // x tile row: 144 bytes, conflict-free frags
constexpr int LB = TN + 8;  // weight tile row (one k): 144 bytes

template <bool W4>
struct Smem {
  static constexpr int H = W4 ? 2 : 1;  // x halves / weight nibbles
  bf16 a[H][TM][LA];
  bf16 b[H][TK][LB];
  float s[TN];  // bf16-rounded scales of the tile's columns, 0 past N
};

union Raw16 {
  int4 v;
  uint8_t b[16];
  uint16_t h[8];
};

// One thread's share (4 chunks of 8) of the 64x64 x tile at rows m0..,
// depths k0.. of the panel that starts at column col0 of x [M, ldx] and
// is Kd deep; rows >= M and depths >= Kd read as zero. `vec`: ldx, col0
// and Kd are multiples of 8 and x is 16-byte aligned.
__device__ __forceinline__ void load_x(int4 (&r)[4], const bf16* __restrict__ x,
                                       int ldx, int col0, int M, int Kd,
                                       int m0, int k0, bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * NT;
    const int m = m0 + c / 8, k = k0 + (c % 8) * 8;
    Raw16 u;
    u.v = make_int4(0, 0, 0, 0);
    if (m < M) {
      const bf16* src = x + static_cast<size_t>(m) * ldx + col0 + k;
      if (vec) {
        if (k < Kd) u.v = *reinterpret_cast<const int4*>(src);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k + j < Kd) u.h[j] = s16[j];
      }
    }
    r[i] = u.v;
  }
}

__device__ __forceinline__ void store_x(bf16 (*a)[LA], const int4 (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * NT;
    *reinterpret_cast<int4*>(&a[c / 8][(c % 8) * 8]) = r[i];
  }
}

// One thread's share (2 chunks of 16 bytes) of the 64x64 tile of weight
// bytes [Kd, N] at rows k0.., columns n0..; out of range reads 0. `vec`:
// N is a multiple of 16 and w is 16-byte aligned.
__device__ __forceinline__ void load_w(int4 (&r)[2],
                                       const uint8_t* __restrict__ w, int N,
                                       int Kd, int k0, int n0, bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * NT;
    const int k = k0 + c / 4, n = n0 + (c % 4) * 16;
    Raw16 u;
    u.v = make_int4(0, 0, 0, 0);
    if (k < Kd) {
      const uint8_t* src = w + static_cast<size_t>(k) * N + n;
      if (vec) {
        if (n < N) u.v = *reinterpret_cast<const int4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N) u.b[j] = src[j];
      }
    }
    r[i] = u.v;
  }
}

// The code of one weight byte (W8: the byte; W4: a nibble minus 8).
template <bool W4>
__device__ __forceinline__ float code_of(uint8_t b, int nibble) {
  if (W4) return static_cast<float>((nibble ? (b >> 4) : (b & 15)) - 8);
  return static_cast<float>(static_cast<int8_t>(b));
}

// Dequantize this thread's weight bytes into the k-major bf16 tile(s):
// bf16(code * bf16(s[n])); rows k >= Kd become zero (a zero packed byte
// would read as -8 otherwise), columns >= N get scale 0.
template <bool W4>
__device__ __forceinline__ void store_w(Smem<W4>& sm, const int4 (&r)[2],
                                        int Kd, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * NT;
    const int kl = c / 4, nl = (c % 4) * 16;
    const bool live = k0 + kl < Kd;
    Raw16 u;
    u.v = r[i];
#pragma unroll
    for (int h = 0; h < Smem<W4>::H; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t p[4] = {0u, 0u, 0u, 0u};
        if (live) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = half * 8 + 2 * j;
            p[j] = pack_bf16(
                __fmul_rn(code_of<W4>(u.b[e], h), sm.s[nl + e]),
                __fmul_rn(code_of<W4>(u.b[e + 1], h), sm.s[nl + e + 1]));
          }
        }
        *reinterpret_cast<int4*>(&sm.b[h][kl][nl + half * 8]) =
            make_int4(p[0], p[1], p[2], p[3]);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// acc[mi][ni] (rows wm + 16 mi, cols wn + 8 ni) += a tile x b tile over
// the TK depths of one step.
__device__ __forceinline__ void warp_mma(const bf16 (*a)[LA],
                                         const bf16 (*b)[LB], int wm, int wn,
                                         int lane, float (&acc)[2][4][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* r0 = a[wm + mi * 16 + g] + kk + 2 * t;
      const bf16* r1 = a[wm + mi * 16 + g + 8] + kk + 2 * t;
      af[mi][0] = ld32(r0);
      af[mi][1] = ld32(r1);
      af[mi][2] = ld32(r0 + 8);
      af[mi][3] = ld32(r1 + 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // matrices: depths kk..+7 / kk+8..+15 at columns n, then n + 8
      uint32_t bf[4];
      ldsm_x4_trans(bf, &b[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                          [wn + np * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

template <bool W4, typename TO>
__global__ void __launch_bounds__(NT)
    wq_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ bias, TO* __restrict__ out, int M,
              int K, int N, bool xvec, bool wvec) {
  __shared__ __align__(16) Smem<W4> sm;
  constexpr int H = Smem<W4>::H;
  const int Kd = W4 ? K / 2 : K;  // weight rows
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  if (tid < TN) {
    const int n = n0 + tid;
    sm.s[tid] = n < N ? __bfloat162float(__float2bfloat16_rn(scale[n]))
                      : 0.f;
  }
  float acc[2][4][4] = {};
  int4 ra[H][4], rw[2];
#pragma unroll
  for (int h = 0; h < H; ++h) load_x(ra[h], x, K, h * Kd, M, Kd, m0, 0, xvec);
  load_w(rw, w, N, Kd, 0, n0, wvec);
  __syncthreads();  // the scales
  for (int k0 = 0; k0 < Kd; k0 += TK) {
#pragma unroll
    for (int h = 0; h < H; ++h) store_x(sm.a[h], ra[h]);
    store_w<W4>(sm, rw, Kd, k0);
    __syncthreads();
    if (k0 + TK < Kd) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        load_x(ra[h], x, K, h * Kd, M, Kd, m0, k0 + TK, xvec);
      load_w(rw, w, N, Kd, k0 + TK, n0, wvec);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) warp_mma(sm.a[h], sm.b[h], wm, wn, lane, acc);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + mi * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (m >= M || n >= N) continue;
        float v = acc[mi][ni][r];
        if (bias) v = __fadd_rn(v, bias[n]);
        store_f32(out + static_cast<size_t>(m) * N + n, v);
      }
}

template <bool W4>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, int M, int K, int N, int out_bf16,
           cudaStream_t stream) {
  const int Kd = W4 ? K / 2 : K;
  const bool xvec = K % 8 == 0 && Kd % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = vec16(w, N);
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (out_bf16) {
    wq_kernel<W4, bf16><<<grid, NT, 0, stream>>>(
        xb, wb, scale, bias, static_cast<bf16*>(out), M, K, N, xvec, wvec);
  } else {
    wq_kernel<W4, float><<<grid, NT, 0, stream>>>(
        xb, wb, scale, bias, static_cast<float*>(out), M, K, N, xvec, wvec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16, w [K, N] int8 codes, scale / bias [N] f32 (bias may be
// null), out [M, N] bf16 or f32.
extern "C" int mixdq_wq_matmul(const void* x, const void* w,
                               const float* scale, const float* bias,
                               void* out, int M, int K, int N, int out_bf16,
                               cudaStream_t stream) {
  return launch<false>(x, w, scale, bias, out, M, K, N, out_bf16, stream);
}

// x [M, K] bf16 (K even), w [K/2, N] halves-packed uint8, scale [N] f32,
// out [M, N] bf16 or f32; no bias (as the TPU kernel).
extern "C" int mixdq_wq4_matmul(const void* x, const void* w,
                                const float* scale, void* out, int M, int K,
                                int N, int out_bf16, cudaStream_t stream) {
  return launch<true>(x, w, scale, nullptr, out, M, K, N, out_bf16, stream);
}
