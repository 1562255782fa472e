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
// :80-87): the code times the bf16 scale, rounded once to bf16 (to
// nearest even). wq4: the packed byte at (k, n) holds code(k, n) + 8 in
// its low nibble and code(k + K/2, n) + 8 in its high nibble, so one
// packed tile of K/2 rows feeds two products: x[:, :K/2] with the low
// nibbles and x[:, K/2:] with the high ones (W4 is the template's only
// difference).
//
// Bound: 2 M K N bf16 operations and the bytes of x, w (1 byte or half a
// byte per element), s and out. At M=1024 K=640 N=5120 that is 6.7 GFLOP,
// ~0.0068 ms at the dense peak; at M <= 256 the weight bytes bound it
// (1x1280x1280: 1.6 MB, ~0.5 us). Far more moves from L2 into shared
// memory: each x tile is read once per column tile and each weight tile
// once per row tile (78 MB at 1024x640x5120 with 128x128 tiles).
//
// Design. A block of 8 warps owns a 128x128 output tile (warps 2 x 4 of
// 64x32, bf16 mma.sync m16n8k16), so each dequantized weight tile feeds
// 128 rows, and at M <= 128 one tile row covers all of M: each weight
// element is dequantized once per split. A k step covers 64 columns of x
// (64 weight rows; wq4: 32 packed rows, both halves). Raw weight bytes
// and x tiles go through a ring of cp.async stages (3 where two blocks
// share an SM, 5 where a block has its SM alone). Step i + 1's weight is
// dequantized while step i is multiplied, into the other of two k-major
// bf16 tiles (rows XOR-swizzled by 16-byte chunk), so a step needs one
// barrier. Dequantization uses no conversion instructions: a nibble
// becomes the mantissa of bf16 128.0, and bf16x2 subtract / fma / multiply
// form the code and its product with the scale (dequant4). A and B
// fragments come from ldmatrix (B transposed), all of a depth before its
// products. Warps skip the 16-row m tiles that lie wholly past M, and
// rows past M are never copied (their outputs are not stored). Rows k
// past the split and columns past N read as zero. The output tile goes
// through shared memory, so that each warp stores whole rows.
//
// Split-K: where the (M, N) tiles fill fewer than the card's SMs, the
// weight rows split into ranges of whole k steps (the plan is
// ops/wq_matmul.py:wq_plan, computed from the shapes and passed in). Each
// split writes its f32 partial sums to a workspace [splits, M, N], and a
// second kernel adds them in split order, adds the bias and casts:
// deterministic, no atomics. Waves: 1024x640x5120 is 320 tiles, no split,
// 2 blocks of 110 KB an SM (264 slots, 1.2 waves); 256x5120x1280 is 20
// tiles x 6 splits, 77x2048x1280 10 x 11, 1x1280x1280 10 x 10: at most
// one block an SM, one wave.

#include "attn_mma.cuh"
#include "cp_async.cuh"

using namespace mixdq;

namespace {

constexpr int TM = 128, TN = 128, NT = 256;  // block tile, threads
constexpr int XCOLS = 64;                    // x columns per k step
constexpr int LC = TN + 8;  // f32 output tile row: conflict-free float2
// ring stages: 3 where two blocks share an SM (more blocks than SMs), 5
// where a block has its SM alone (the split-K grids)
constexpr int STAGES_SHARED = 3, STAGES_ALONE = 5;

template <bool W4>
struct Cfg {
  static constexpr int H = W4 ? 2 : 1;    // x halves / weight nibbles
  static constexpr int TK = XCOLS / H;    // weight rows per k step
  static constexpr int LA = TK + 8;       // x tile row, bf16 (padded)
  static constexpr int X_BYTES = H * TM * LA * 2;
  static constexpr int W_BYTES = TK * TN;  // raw weight bytes
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int B_ELEMS = H * TK * TN;  // one dequantized tile
  // ring, two dequantized tiles, scales; the output tile reuses the ring
  static constexpr int smem(int stages) {
    return stages * STAGE + 2 * B_ELEMS * 2 + TN * 2;
  }
  static_assert(3 * STAGE >= TM * LC * 4, "output tile exceeds the ring");
  static_assert(3 * STAGE + 4 * B_ELEMS + TN * 2 <= 113 * 1024,
                "two blocks of the shallow ring no longer fit on an SM");
};

union Raw16 {
  int4 v;
  uint8_t b[16];
  uint16_t h[8];
  uint32_t w[4];
};

// How the raw weight bytes are copied: 16-byte cp.async (N a multiple of
// 16), 4-byte cp.async (N a multiple of 4) or byte loads.
enum WMode { W_COPY16 = 0, W_COPY4 = 1, W_COPY1 = 2 };

struct Operands {
  const bf16* x;
  const uint8_t* w;
  int M, K, N, Kd;     // Kd: weight rows (K, or K/2 packed)
  int m0, n0, k_end;   // the tile's first row / column, the split's end
  bool xvec;           // K, Kd multiples of 8 and x on 16 bytes
  int wmode;
};

// Block-wide: the x tiles (H halves x TM rows x TK columns) and the raw
// weight tile (TK rows x TN bytes) of the k step at weight row k0 into
// ring stage `st`, then one commit group (empty when !live).
template <bool W4>
__device__ __forceinline__ void issue_step(unsigned char* st,
                                           const Operands& op, int k0,
                                           bool live) {
  using C = Cfg<W4>;
  if (live) {
    bf16* xs = reinterpret_cast<bf16*>(st);
    uint8_t* wsm = st + C::X_BYTES;
    constexpr int XCH = C::TK / 8, XN = C::H * TM * XCH;
#pragma unroll
    for (int it = 0; it < XN / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int h = i / (TM * XCH), row = i / XCH % TM, c = i % XCH * 8;
      const int m = op.m0 + row, k = k0 + c;
      if (m >= op.M) continue;
      bf16* dst = xs + (h * TM + row) * C::LA + c;
      const bf16* src = op.x + static_cast<size_t>(m) * op.K + h * op.Kd + k;
      if (op.xvec) {
        cp_async16(smem_addr(dst), k < op.k_end ? src : op.x, k < op.k_end);
      } else {
        Raw16 u;
        u.v = make_int4(0, 0, 0, 0);
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k + j < op.k_end) u.h[j] = s16[j];
        *reinterpret_cast<int4*>(dst) = u.v;
      }
    }
    constexpr int WCH = TN / 16, WN = C::TK * WCH;
#pragma unroll
    for (int it = 0; it < WN / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int kl = i / WCH, c = i % WCH * 16;
      const int k = k0 + kl, n = op.n0 + c;
      uint8_t* dst = wsm + kl * TN + c;
      const uint8_t* src = op.w + static_cast<size_t>(k) * op.N + n;
      const bool krow = k < op.k_end;
      if (op.wmode == W_COPY16) {
        const bool ok = krow && n < op.N;
        cp_async16(smem_addr(dst), ok ? src : op.w, ok);
      } else if (op.wmode == W_COPY4) {
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const bool ok = krow && n + j < op.N;
          cp_async4(smem_addr(dst + j), ok ? src + j : op.w, ok);
        }
      } else {
        Raw16 u;
        u.v = make_int4(0, 0, 0, 0);
        if (krow) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (n + j < op.N) u.b[j] = src[j];
        }
        *reinterpret_cast<int4*>(dst) = u.v;
      }
    }
  }
  cp_async_commit();
}

// bf16x2 of nibbles a, b (0..15) as 128 + a, 128 + b: the nibble is the
// low mantissa of 0x4300 (128.0, mantissa step 1). sel picks bytes of
// the nibble word t: 0x4140 bytes 0 and 1, 0x4342 bytes 2 and 3.
__device__ __forceinline__ __nv_bfloat162 nib2(uint32_t t, uint32_t sel) {
  const uint32_t v = __byte_perm(t, 0x43u, sel);
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// The dequantized bf16 pairs of the four weight bytes in `word` (columns
// j..j+3, scales s01 / s23), without conversion instructions: every step
// is exact but the final multiply, which rounds code * s once.
// W8: the code c = 16 hi + lo - 128 of u = byte ^ 0x80 comes from its
// nibbles, hi = (128 + hi) - 128 and lo - 128 = (128 + lo) - 256, as
// c = fma(hi, 16, lo - 128) (exact: |c| <= 128). W4: c = (128 + n) - 136
// for the nibble n of half h.
template <bool W4>
__device__ __forceinline__ void dequant4(uint32_t word, int h,
                                         __nv_bfloat162 s01,
                                         __nv_bfloat162 s23,
                                         uint32_t (&o)[2]) {
  const __nv_bfloat162 c128 = __float2bfloat162_rn(128.f);
  __nv_bfloat162 c[2];
  if (W4) {
    const uint32_t t = (h ? word >> 4 : word) & 0x0f0f0f0fu;
    const __nv_bfloat162 c136 = __float2bfloat162_rn(136.f);
    c[0] = __hsub2(nib2(t, 0x4140u), c136);
    c[1] = __hsub2(nib2(t, 0x4342u), c136);
  } else {
    const uint32_t u = word ^ 0x80808080u;
    const uint32_t lo = u & 0x0f0f0f0fu, hi = (u >> 4) & 0x0f0f0f0fu;
    const __nv_bfloat162 c256 = __float2bfloat162_rn(256.f);
    const __nv_bfloat162 c16 = __float2bfloat162_rn(16.f);
    c[0] = __hfma2(__hsub2(nib2(hi, 0x4140u), c128), c16,
                   __hsub2(nib2(lo, 0x4140u), c256));
    c[1] = __hfma2(__hsub2(nib2(hi, 0x4342u), c128), c16,
                   __hsub2(nib2(lo, 0x4342u), c256));
  }
  const __nv_bfloat162 d0 = __hmul2(c[0], s01), d1 = __hmul2(c[1], s23);
  o[0] = *reinterpret_cast<const uint32_t*>(&d0);
  o[1] = *reinterpret_cast<const uint32_t*>(&d1);
}

// The 16-byte chunk of a dequantized tile row (TN bf16, 256 bytes) that
// holds logical chunk c: XOR-swizzled by the row, so that the 8 rows of
// an ldmatrix hit distinct banks without padding.
__device__ __forceinline__ int bswz(int row, int c) { return c ^ (row & 7); }

// Block-wide: the raw weight tile of one step into the k-major bf16
// tile(s) B: bf16(code * bf16(s[n])); rows at or past k_end become zero
// (a zero packed byte would read as -8), columns past N have scale 0.
template <bool W4>
__device__ __forceinline__ void dequant(bf16* B, const uint8_t* wsm,
                                        const __nv_bfloat162* sc2, int k0,
                                        int k_end) {
  using C = Cfg<W4>;
  constexpr int WCH = TN / 16, WN = C::TK * WCH;
#pragma unroll
  for (int it = 0; it < WN / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int kl = i / WCH, nl = i % WCH * 16;
    const bool live = k0 + kl < k_end;
    Raw16 u;
    u.v = *reinterpret_cast<const int4*>(wsm + kl * TN + nl);
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
      Raw16 o[2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t d[2];
        dequant4<W4>(u.w[q], h, sc2[nl / 2 + 2 * q], sc2[nl / 2 + 2 * q + 1],
                     d);
        o[q / 2].w[(q % 2) * 2] = live ? d[0] : 0u;
        o[q / 2].w[(q % 2) * 2 + 1] = live ? d[1] : 0u;
      }
      bf16* row = B + (h * C::TK + kl) * TN;
      *reinterpret_cast<int4*>(row + bswz(kl, nl / 8) * 8) = o[0].v;
      *reinterpret_cast<int4*>(row + bswz(kl, nl / 8 + 1) * 8) = o[1].v;
    }
  }
}

// acc[mi][ni] (rows wm + 16 mi, cols wn + 8 ni) += x tile . B tile over
// the TK depths of one step; m tiles mi >= mtiles are skipped (all their
// rows lie past M).
template <int TK>
__device__ __forceinline__ void warp_mma(const bf16* xs, int la,
                                         const bf16* B, int wm, int wn,
                                         int mtiles, int lane,
                                         float (&acc)[4][4][4]) {
  const int r16 = (lane & 7) + ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    // every fragment of the depth first, then its 16 products: one load
    // latency a depth, not one per m tile
    uint32_t bf[2][4], af[4][4];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_trans(bf[np], smem_addr(B + (kk + r16) * TN +
                                          bswz(lane, (wn + np * 16 + c8) / 8) *
                                              8));
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      if (mi < mtiles)
        ldsm_x4(af[mi], smem_addr(xs + (wm + mi * 16 + r16) * la + kk + c8));
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mi >= mtiles) continue;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float4& v, bool vec,
                                       int cols) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < cols; ++j) p[j] = e[j];
  }
}
__device__ __forceinline__ void store4(bf16* p, const float4& v, bool vec,
                                       int cols) {
  if (vec) {
    const uint2 u = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < cols; ++j) p[j] = __float2bfloat16_rn(e[j]);
  }
}

// One (128 x 128 tile, split) of the product, through a ring of S stages.
// part: the split's f32 partial sums [splits, M, N] (no bias), or null
// when there is one split (out written with the bias). The output tile
// goes through shared memory, so that each warp writes whole rows.
template <bool W4, int S, typename TO>
__global__ void __launch_bounds__(NT, S == STAGES_SHARED ? 2 : 1)
    wq_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ bias, TO* __restrict__ out,
              float* __restrict__ part, int M, int K, int N, int split_rows,
              bool xvec, int wmode) {
  using C = Cfg<W4>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* B = reinterpret_cast<bf16*>(smem + S * C::STAGE);  // two tiles
  __nv_bfloat162* sc2 = reinterpret_cast<__nv_bfloat162*>(B + 2 * C::B_ELEMS);
  const int Kd = W4 ? K / 2 : K;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, split = blockIdx.z;
  const int k_begin = split * split_rows;
  const int k_end = min(Kd, k_begin + split_rows);
  const int steps = (k_end - k_begin + C::TK - 1) / C::TK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  if (tid < TN / 2) {  // read after the loop's first barrier
    const int n = n0 + 2 * tid;
    sc2[tid] = __halves2bfloat162(
        __float2bfloat16_rn(n < N ? scale[n] : 0.f),
        __float2bfloat16_rn(n + 1 < N ? scale[n + 1] : 0.f));
  }
  const Operands op{x, w, M, K, N, Kd, m0, n0, k_end, xvec, wmode};
#pragma unroll
  for (int s = 0; s < S - 1; ++s)
    issue_step<W4>(smem + s * C::STAGE, op, k_begin + s * C::TK, s < steps);
  const int mtiles = max(0, min(4, (M - m0 - wm + 15) / 16));
  float acc[4][4][4] = {};
  // Step i's weight is dequantized in the iteration before its product,
  // into the other of two tiles, so that one barrier a step suffices and
  // a warp's conversions interleave with its mma.sync.
  cp_async_wait<S - 2>();
  __syncthreads();  // step 0 landed; the scales are written
  dequant<W4>(B, smem + C::X_BYTES, sc2, k_begin, k_end);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 3>();
    // step i + 1 landed, step i's tile is whole, and every warp is done
    // with step i - 1 (its stage and tile)
    __syncthreads();
    const int nx = i + S - 1;
    issue_step<W4>(smem + nx % S * C::STAGE, op, k_begin + nx * C::TK,
                   nx < steps);
    if (i + 1 < steps)
      dequant<W4>(B + ((i + 1) & 1) * C::B_ELEMS,
                  smem + (i + 1) % S * C::STAGE + C::X_BYTES, sc2,
                  k_begin + (i + 1) * C::TK, k_end);
    const bf16* xs = reinterpret_cast<const bf16*>(smem + i % S * C::STAGE);
    const bf16* bt = B + (i & 1) * C::B_ELEMS;
#pragma unroll
    for (int h = 0; h < C::H; ++h)
      warp_mma<C::TK>(xs + h * TM * C::LA, C::LA, bt + h * C::TK * TN, wm,
                      wn, mtiles, lane, acc);
  }
  cp_async_wait<0>();  // only empty groups remain; the ring is free
  __syncthreads();
  float* ct = reinterpret_cast<float*>(smem);  // [TM][LC] f32
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi >= mtiles) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(
            ct + (wm + mi * 16 + g + hr * 8) * LC + wn + ni * 8 + 2 * t) =
            make_float2(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
  }
  __syncthreads();
  // a warp per row, 4 columns a lane
  const int n = n0 + lane * 4, cols = min(4, N - n);
  const bool vec = (N & 3) == 0 && cols == 4;
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias && !part && cols > 0) {
    b4.x = bias[n];
    if (cols > 1) b4.y = bias[n + 1];
    if (cols > 2) b4.z = bias[n + 2];
    if (cols > 3) b4.w = bias[n + 3];
  }
  for (int r = warp; r < TM; r += NT / 32) {
    const int m = m0 + r;
    if (m >= M || cols <= 0) continue;
    float4 v = *reinterpret_cast<const float4*>(ct + r * LC + lane * 4);
    if (part) {
      store4(part + (static_cast<size_t>(split) * M + m) * N + n, v, vec,
             cols);
      continue;
    }
    if (bias) {
      v.x = __fadd_rn(v.x, b4.x);
      v.y = __fadd_rn(v.y, b4.y);
      v.z = __fadd_rn(v.z, b4.z);
      v.w = __fadd_rn(v.w, b4.w);
    }
    store4(out + static_cast<size_t>(m) * N + n, v, vec, cols);
  }
}

// out = sum of the splits' partials in split order (+ bias), cast.
template <typename TO>
__global__ void __launch_bounds__(256)
    wq_reduce(const float* __restrict__ part, const float* __restrict__ bias,
              TO* __restrict__ out, int MN, int N, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s)
      v = __fadd_rn(v, part[static_cast<size_t>(s) * MN + i]);
    if (bias) v = __fadd_rn(v, bias[i % N]);
    store_f32(out + i, v);
  }
}

// The ring's dynamic shared memory and the largest carveout; once per
// kernel.
template <bool W4, int S, typename TO>
cudaError_t wq_attrs() {
  cudaError_t e = cudaFuncSetAttribute(
      wq_kernel<W4, S, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<W4>::smem(S));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(wq_kernel<W4, S, TO>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool W4, int S, typename TO>
int run(const bf16* x, const uint8_t* w, const float* scale,
        const float* bias, TO* out, float* part, int M, int K, int N,
        int splits, int split_rows, bool xvec, int wmode,
        cudaStream_t stream) {
  static const cudaError_t attrs = wq_attrs<W4, S, TO>();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  wq_kernel<W4, S, TO><<<grid, NT, Cfg<W4>::smem(S), stream>>>(
      x, w, scale, splits > 1 ? nullptr : bias, out,
      splits > 1 ? part : nullptr, M, K, N, split_rows, xvec, wmode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int MN = M * N;
  const int blocks = min((MN + 255) / 256, 4096);
  wq_reduce<TO><<<blocks, 256, 0, stream>>>(part, bias, out, MN, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4, typename TO>
int run_stages(int stages, const bf16* x, const uint8_t* w,
               const float* scale, const float* bias, TO* out, float* part,
               int M, int K, int N, int splits, int split_rows, bool xvec,
               int wmode, cudaStream_t stream) {
  if (stages == STAGES_SHARED)
    return run<W4, STAGES_SHARED, TO>(x, w, scale, bias, out, part, M, K, N,
                                      splits, split_rows, xvec, wmode,
                                      stream);
  return run<W4, STAGES_ALONE, TO>(x, w, scale, bias, out, part, M, K, N,
                                   splits, split_rows, xvec, wmode, stream);
}

template <bool W4>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, float* part, int M, int K, int N,
           int out_bf16, int tm, int tn, int tk, int stages, int splits,
           int split_rows, cudaStream_t stream) {
  const int Kd = W4 ? K / 2 : K;
  // the plan (ops/wq_matmul.py:wq_plan) must be this build's tiles and
  // ring depths, its splits whole k steps covering the weight rows once
  if (tm != TM || tn != TN || tk != Cfg<W4>::TK ||
      (stages != STAGES_SHARED && stages != STAGES_ALONE) || splits < 1 ||
      split_rows <= 0 || split_rows % tk ||
      static_cast<long long>(splits) * split_rows < Kd ||
      static_cast<long long>(splits - 1) * split_rows >= max(Kd, 1) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xvec = K % 8 == 0 && Kd % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int wmode = vec16(w, N)                     ? W_COPY16
                    : N % 4 == 0 && wa % 4 == 0 ? W_COPY4
                                                    : W_COPY1;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (out_bf16)
    return run_stages<W4, bf16>(stages, xb, wb, scale, bias,
                                static_cast<bf16*>(out), part, M, K, N,
                                splits, split_rows, xvec, wmode, stream);
  return run_stages<W4, float>(stages, xb, wb, scale, bias,
                               static_cast<float*>(out), part, M, K, N,
                               splits, split_rows, xvec, wmode, stream);
}

}  // namespace

// x [M, K] bf16, w [K, N] int8 codes, scale / bias [N] f32 (bias may be
// null), out [M, N] bf16 or f32; part: f32 [splits, M, N] when splits > 1.
// tm, tn, tk, stages, splits, split_rows: the plan of
// ops/wq_matmul.py:wq_plan.
extern "C" int mixdq_wq_matmul(const void* x, const void* w,
                               const float* scale, const float* bias,
                               void* out, float* part, int M, int K, int N,
                               int out_bf16, int tm, int tn, int tk,
                               int stages, int splits, int split_rows,
                               cudaStream_t stream) {
  return launch<false>(x, w, scale, bias, out, part, M, K, N, out_bf16, tm,
                       tn, tk, stages, splits, split_rows, stream);
}

// x [M, K] bf16 (K even), w [K/2, N] halves-packed uint8, scale [N] f32,
// out [M, N] bf16 or f32; no bias (as the TPU kernel); the plan splits
// the K/2 packed rows.
extern "C" int mixdq_wq4_matmul(const void* x, const void* w,
                                const float* scale, void* out, float* part,
                                int M, int K, int N, int out_bf16, int tm,
                                int tn, int tk, int stages, int splits,
                                int split_rows, cudaStream_t stream) {
  return launch<true>(x, w, scale, nullptr, out, part, M, K, N, out_bf16, tm,
                      tn, tk, stages, splits, split_rows, stream);
}
