// Whole-attention int8 kernels of the attn_impl="auto" path.
//
// Replaces mixdq_tpu/ops/pallas_sec_attention.py:sec_attention (pallas_call
// at :151), :sec_attention_q (:271), :sec_attention_qkv (:460) and
// :sec_attention_q_out (:927). All four end in the JAX _attend_codes
// (:37-69), per head:
//
//   s = (q . k^T) * scale           f32 logits, scale after the dot
//   m = max_j s                     over ALL keys before any exp
//   p = exp(s - m); l = sum_j p     l from the f32 p
//   o = (bf16(p) . v) / l           p cast to v's dtype, divided, not
//   codes = quantize(o)             multiplied by 1/l
//
// The TPU kernels hold a whole [Tq, Tk] f32 logits tile in VMEM; here a
// warp owns 16 query rows of one head and streams the keys in chunks of
// KC through shared memory twice: pass 1 takes the row max, pass 2
// recomputes the same logits (same mma order, bit for bit), forms p with
// the final max, sums l and accumulates p.v. QK^T and PV run on
// mma.sync m16n8k16 (bf16 x bf16 -> f32); f32 q/k/v (f32 models) take a
// scalar path. q/k/v are read in place at their column offsets with their
// sources' row strides, as the TPU's block index maps read them.
//
// sec_attention (attn1 at the 32x32 level of SDXL 1024, attn2 at its
// 64x64 level, and "auto" without fused QKV/KV): a plain launch of one
// block per (batch, head, 64-row) tile, q/k/v from their projections'
// outputs. Bound at T=1024 C=1280 (20 heads): 5.4 GFLOP of bf16 attention,
// ~5.4 us at the dense peak.
//
// sec_attention_q (attn2 at SDXL 1024's 32x32 level): one cooperative
// launch: the to_q GEMM (int8 mma.sync, epilogue (f32(acc) - bias0) *
// scale, cast to k's dtype) into a q workspace, one grid-wide sync, then
// the attention tiles over the k/v panels of the fused to_kv output. The
// TPU kernel runs both per head panel in one grid step; a Hopper block
// owning a head panel would run its (C_in/32) GEMM k-steps over the whole
// Tq alone. Bound at Tq=1024 C_in=C=1280: 3.4 GOP of int8 (~1.7 us) plus
// 0.4 GFLOP of bf16 attention.
//
// sec_attention_qkv (every attn1 of SDXL-Turbo): one cooperative launch.
// Phase 1 runs the fused [C, 3C] QKV GEMM into a [B*T, 3C] bf16
// workspace; one grid-wide sync; phase 2 runs (batch, head, 64-row)
// attention tiles that read q/k/v from it and write to_out's codes.
// Blocks walk both phases' tiles in a grid stride; nothing depends on
// block order. Bound at T=1024 C=640 (10 heads): int8 GEMM 2.5 GOP and
// bf16 attention 2.7 GFLOP, ~1.3 + ~2.7 us at the dense peaks.
//
// sec_attention_q_out (every attn2 of SDXL-Turbo): one cooperative launch
// of the same shape, in grid-stride stages separated by grid-wide syncs:
// (LN-folded mode) LayerNorm + to_q act-quantize of every row into a
// codes workspace; the to_q GEMM into a q workspace (k's dtype);
// attention tiles over the k/v panels of the fused to_kv output into a
// to_out codes workspace; the to_out GEMM + bias + residual. The TPU's
// int32 acc_ref carried across the head grid has no counterpart: each
// to_out tile sums the whole C in one block. One block per row tile
// across all heads (every stage row-local, no grid sync) would leave one
// block to run 2 (C_in/32)(C/64) GEMM k-steps in series, 1600 at the
// 16x16 level; the stages spread them over the card instead. Bound at
// T=256 C=1280: the weight bytes (3.3 MB, ~1 us) and 1.7 GOP of int8
// (~0.8 us).
//
// sec_attention_qkv_out (attn1 of SDXL-Turbo under out_fuse with "attn1";
// replaces :sec_attention_qkv_out, pallas_call at :757, bodies
// _sec_qkv_out_kernel :503 and _sec_qkv_lnout_kernel :525): one
// cooperative launch, sec_attention_qkv's stages between sec_q_out's
// first and last: (LN-folded mode) LayerNorm + to_qkv act-quantize of
// every row into a codes workspace; the fused [C, 3C] QKV GEMM into a bf16
// workspace (q/k/v are bf16 whatever the model dtype, as the TPU kernel
// casts them); attention tiles into a to_out codes workspace; the to_out
// GEMM with bias and residual (the raw input in LN-folded mode) in the
// model dtype. The TPU kernel sums to_out over its head panels in an
// int32 scratch; one to_out tile here sums the whole C, the same integer.
// Bound at T=1024 C=640: int8 2.5 + 0.84 GOP and 2.7 GFLOP of bf16
// attention, ~4.4 us at the dense peaks.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "attn_mma.cuh"

namespace cg = cooperative_groups;
using namespace mixdq;

struct Quant {
  float sinv, zp, lo, hi;
};

// Block-wide attention of one head over bf16 q/k/v for a 64-row tile
// (nq valid rows): warp w takes query rows 16 w ..+16. Writes the
// quantized o to h.out.
template <int D>
__device__ void attend_bf16(void* smem, const HeadPanels<bf16>& h, int ldq,
                            int ldk, int ldv, int ldo, int nq, int Tk,
                            float scale, Quant oq) {
  constexpr int KC = Chunk<D>::KC;
  Chunk<D>& sm = *static_cast<Chunk<D>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows

  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, h.q, ldq, ra, rb, nq, t);

  float s[KC / 8][4];
  float ma = -INFINITY, mb = -INFINITY;
  for (int c0 = 0; c0 < Tk; c0 += KC) {  // pass 1: row max
    load_chunk<D>(sm, h, ldk, ldv, Tk, c0, false);
    __syncthreads();
    chunk_logits<D>(sm, qf, s, g, t);
#pragma unroll
    for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (c0 + nt * 8 + 2 * t + (r & 1) >= Tk) continue;
        const float v = __fmul_rn(s[nt][r], scale);
        if (r < 2) ma = fmaxf(ma, v);
        else mb = fmaxf(mb, v);
      }
    __syncthreads();
  }
  ma = quad_max(ma);
  mb = quad_max(mb);

  float la = 0.f, lb = 0.f;
  float o[D / 8][4] = {};
  for (int c0 = 0; c0 < Tk; c0 += KC) {  // pass 2: p, l, p.v
    load_chunk<D>(sm, h, ldk, ldv, Tk, c0, true);
    __syncthreads();
    chunk_logits<D>(sm, qf, s, g, t);
#pragma unroll
    for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = 0.f;
        if (c0 + nt * 8 + 2 * t + (r & 1) < Tk)
          p = expf(__fsub_rn(__fmul_rn(s[nt][r], scale), r < 2 ? ma : mb));
        s[nt][r] = p;
        if (r < 2) la += p;
        else lb += p;
      }
    chunk_pv<D>(sm, s, o, g, t);
    __syncthreads();
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r < 2 ? ra : rb;
      if (row >= nq) continue;
      const float val = __fdiv_rn(o[dt][r], r < 2 ? la : lb);
      h.out[static_cast<size_t>(row) * ldo + dt * 8 + 2 * t + (r & 1)] =
          quant_code(val, oq.sinv, oq.zp, oq.lo, oq.hi);
    }
}

// The same attention over f32 q/k/v (p stays f32, as p.astype(f32)), by
// one warp for rows [0, nq) of h, one row at a time: a lane per key for
// the logits, a lane per column for p.v. No shared memory and no block
// synchronization.
template <int D>
__device__ void attend_f32(const HeadPanels<float>& h, int ldq, int ldk,
                           int ldv, int ldo, int nq, int Tk, float scale,
                           Quant oq) {
  constexpr int NC = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nq; ++r) {
    const float* qr = h.q + static_cast<size_t>(r) * ldq;
    float m = -INFINITY;
    for (int j0 = 0; j0 < Tk; j0 += 32) {
      const int j = j0 + lane;
      if (j < Tk)
        m = fmaxf(m, __fmul_rn(
                         dot_f32(qr, h.k + static_cast<size_t>(j) * ldk, D),
                         scale));
    }
    m = warp_max(m);
    float l = 0.f, o[NC] = {};
    for (int j0 = 0; j0 < Tk; j0 += 32) {
      const int j = j0 + lane;
      float p = 0.f;
      if (j < Tk)
        p = expf(__fsub_rn(
            __fmul_rn(dot_f32(qr, h.k + static_cast<size_t>(j) * ldk, D),
                      scale),
            m));
      l += p;
      for (int jj = 0; jj < 32 && j0 + jj < Tk; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = h.v + static_cast<size_t>(j0 + jj) * ldv;
#pragma unroll
        for (int i = 0; i < NC; ++i)
          if (lane + 32 * i < D) o[i] += pj * vr[lane + 32 * i];
      }
    }
    l = warp_sum(l);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane + 32 * i < D)
        h.out[static_cast<size_t>(r) * ldo + lane + 32 * i] =
            quant_code(__fdiv_rn(o[i], l), oq.sinv, oq.zp, oq.lo, oq.hi);
  }
}

constexpr int GEMM_SMEM = 2 * BM * LDS;

// Shared memory of a block: GEMM tiles, or one head's k/v chunk (bf16).
template <int D, bool KV>
__host__ __device__ constexpr int smem_bytes() {
  return KV && static_cast<int>(sizeof(Chunk<D>)) > GEMM_SMEM
             ? static_cast<int>(sizeof(Chunk<D>))
             : GEMM_SMEM;
}

// ---------------------------------------------------------------------------
// Grid-stride stages (every block of the cooperative grid calls each)
// ---------------------------------------------------------------------------

// out[M, N] = T((f32(A @ W) - bias0) * scale), 64x64 tiles.
template <typename T>
__device__ void proj_stage(char* smem, const int8_t* A, int M, int K,
                           bool avec, const int8_t* W, int N, bool bvec,
                           const float* scale, const float* bias0, T* out) {
  auto As = reinterpret_cast<int8_t(*)[LDS]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[LDS]>(smem + BM * LDS);
  const int nt = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * nt;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    gemm_tile(A, M, K, tile / nt * BM, avec, W, N, tile % nt * BN, bvec, As,
              Bs, [&](int m, int n, int acc) {
                if (m >= M || n >= N) return;
                store_f32(out + static_cast<size_t>(m) * N + n,
                          __fmul_rn(__fsub_rn(__int2float_rn(acc), bias0[n]),
                                    scale[n]));
              });
}

// Attention tiles (batch element, head, 64 query rows): q rows of batch
// element b start at q + b Tq ldq, k/v at k + b Tk ldk; codes to out.
template <typename T, int D>
__device__ void attn_stage(char* smem, const T* q, int ldq, const T* k,
                           int ldk, const T* v, int ldv, int8_t* out,
                           int ldo, int B, int Tq, int Tk, int heads,
                           float scale, Quant oq) {
  const int rt = (Tq + 63) / 64;
  for (int tile = blockIdx.x; tile < B * heads * rt; tile += gridDim.x) {
    const int r = tile % rt, h = tile / rt % heads, b = tile / rt / heads;
    const size_t row0 = static_cast<size_t>(b) * Tq + r * 64;
    const size_t key0 = static_cast<size_t>(b) * Tk;
    const int nq = min(64, Tq - r * 64);
    if constexpr (std::is_same<T, bf16>::value) {
      const HeadPanels<bf16> hp{q + row0 * ldq + h * D,
                                k + key0 * ldk + h * D,
                                v + key0 * ldv + h * D,
                                out + row0 * ldo + h * D};
      attend_bf16<D>(smem, hp, ldq, ldk, ldv, ldo, nq, Tk, scale, oq);
    } else {  // a warp per 16 rows
      const int w16 = (threadIdx.x >> 5) * 16;
      const HeadPanels<float> hp{q + (row0 + w16) * ldq + h * D,
                                 k + key0 * ldk + h * D,
                                 v + key0 * ldv + h * D,
                                 out + (row0 + w16) * ldo + h * D};
      attend_f32<D>(hp, ldq, ldk, ldv, ldo, max(0, min(16, nq - w16)), Tk,
                    scale, oq);
    }
  }
}

// ---------------------------------------------------------------------------
// sec_attention
// ---------------------------------------------------------------------------

template <typename T>
struct AttnArgs {
  const T* q;  // row 0, column q_off, of batch element 0
  const T* k;
  const T* v;
  int8_t* out;  // [B*Tq, heads*D]
  int ldq, ldk, ldv, B, Tq, Tk, heads;
  float sm_scale;
  Quant oq;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) sec_attn_kernel(const AttnArgs<T> a) {
  // f32 q/k/v take the scalar path, which needs no shared memory
  __shared__ __align__(16) char
      smem[std::is_same<T, bf16>::value ? sizeof(Chunk<D>) : 16];
  attn_stage<T, D>(smem, a.q, a.ldq, a.k, a.ldk, a.v, a.ldv, a.out,
                   a.heads * D, a.B, a.Tq, a.Tk, a.heads, a.sm_scale, a.oq);
}

template <typename T, int D>
static int launch_attn(const AttnArgs<T>& a, cudaStream_t stream) {
  const int grid = a.B * a.heads * ((a.Tq + 63) / 64);
  sec_attn_kernel<T, D><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int attn(const void* q, const void* k, const void* v, int ldq,
                int ldk, int ldv, int8_t* out, int B, int Tq, int Tk,
                int heads, int d, float sm_scale, Quant oq,
                cudaStream_t stream) {
  const AttnArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), out, ldq, ldk, ldv, B, Tq,
                      Tk, heads, sm_scale, oq};
  switch (d) {
    case 16: return launch_attn<T, 16>(a, stream);
    case 32: return launch_attn<T, 32>(a, stream);
    case 64: return launch_attn<T, 64>(a, stream);
    case 128: return launch_attn<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_sec_attention(const void* q, const void* k,
                                   const void* v, int ldq, int ldk, int ldv,
                                   int8_t* out, int B, int Tq, int Tk,
                                   int heads, int d, int is_bf16,
                                   float sm_scale, float sinv, float zp,
                                   float lo, float hi, cudaStream_t stream) {
  auto fn = is_bf16 ? attn<bf16> : attn<float>;
  return fn(q, k, v, ldq, ldk, ldv, out, B, Tq, Tk, heads, d, sm_scale,
            Quant{sinv, zp, lo, hi}, stream);
}

// ---------------------------------------------------------------------------
// sec_attention_q
// ---------------------------------------------------------------------------

template <typename T>
struct QArgs {
  const int8_t* x;  // [B*Tq, C_in] to_q codes
  const int8_t* wq;  // [C_in, C]
  const float* sq;
  const float* b0q;
  const T* k;  // key 0, column k_off, of batch element 0
  const T* v;
  int ldk, ldv;
  T* q;         // [B*Tq, C] workspace
  int8_t* out;  // [B*Tq, C]
  int B, Tq, Tk, Cin, heads;
  float sm_scale;
  Quant oq;
  bool avec, bvec;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) sec_q_kernel(const QArgs<T> a) {
  __shared__ __align__(16) char
      smem[smem_bytes<D, std::is_same<T, bf16>::value>()];
  const int C = a.heads * D;
  proj_stage<T>(smem, a.x, a.B * a.Tq, a.Cin, a.avec, a.wq, C, a.bvec, a.sq,
                a.b0q, a.q);
  cg::this_grid().sync();
  attn_stage<T, D>(smem, a.q, C, a.k, a.ldk, a.v, a.ldv, a.out, C, a.B, a.Tq,
                   a.Tk, a.heads, a.sm_scale, a.oq);
}

template <typename T, int D>
static int launch_q(QArgs<T> a, cudaStream_t stream) {
  const int tiles = std::max(tiles64(a.B * a.Tq, a.heads * D),
                             a.B * a.heads * ((a.Tq + 63) / 64));
  const int grid = cooperative_grid(sec_q_kernel<T, D>, tiles);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sec_q_kernel<T, D>),
                              dim3(grid), dim3(THREADS), args, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int attn_q(const int8_t* x, const int8_t* wq, const float* sq,
                  const float* b0q, const void* k, const void* v, int ldk,
                  int ldv, void* q, int8_t* out, int B, int Tq, int Tk,
                  int Cin, int heads, int d, float sm_scale, Quant oq,
                  cudaStream_t stream) {
  const QArgs<T> a{x, wq, sq, b0q, static_cast<const T*>(k),
                   static_cast<const T*>(v), ldk, ldv, static_cast<T*>(q),
                   out, B, Tq, Tk, Cin, heads, sm_scale, oq, vec16(x, Cin),
                   vec16(wq, heads * d)};
  switch (d) {
    case 16: return launch_q<T, 16>(a, stream);
    case 32: return launch_q<T, 32>(a, stream);
    case 64: return launch_q<T, 64>(a, stream);
    case 128: return launch_q<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_sec_attention_q(const int8_t* x, const int8_t* wq,
                                     const float* sq, const float* b0q,
                                     const void* k, const void* v, int ldk,
                                     int ldv, void* q, int8_t* out, int B,
                                     int Tq, int Tk, int Cin, int heads,
                                     int d, int is_bf16, float sm_scale,
                                     float sinv, float zp, float lo,
                                     float hi, cudaStream_t stream) {
  auto fn = is_bf16 ? attn_q<bf16> : attn_q<float>;
  return fn(x, wq, sq, b0q, k, v, ldk, ldv, q, out, B, Tq, Tk, Cin, heads,
            d, sm_scale, Quant{sinv, zp, lo, hi}, stream);
}

// ---------------------------------------------------------------------------
// sec_attention_qkv
// ---------------------------------------------------------------------------

struct QkvArgs {
  const int8_t* x;  // [B*T, C] codes
  const int8_t* w;  // [C, 3C]
  const float* scale;
  const float* bias0;  // [3C]
  bf16* ws;            // [B*T, 3C] workspace
  int8_t* out;         // [B*T, C]
  int B, T, C, heads;
  float sm_scale;
  Quant oq;
  bool avec, bvec;
};

template <int D>
__global__ void __launch_bounds__(THREADS) sec_qkv_kernel(const QkvArgs a) {
  __shared__ __align__(16) char smem[smem_bytes<D, true>()];
  const int N = 3 * a.C;
  proj_stage<bf16>(smem, a.x, a.B * a.T, a.C, a.avec, a.w, N, a.bvec,
                   a.scale, a.bias0, a.ws);
  cg::this_grid().sync();
  attn_stage<bf16, D>(smem, a.ws, N, a.ws + a.C, N, a.ws + 2 * a.C, N, a.out,
                      a.C, a.B, a.T, a.T, a.heads, a.sm_scale, a.oq);
}

template <int D>
static int launch_qkv(QkvArgs a, cudaStream_t stream) {
  const int proj = tiles64(a.B * a.T, 3 * a.C);
  const int attn = a.B * a.heads * ((a.T + 63) / 64);
  const int grid = cooperative_grid(sec_qkv_kernel<D>, std::max(proj, attn));
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sec_qkv_kernel<D>),
                              dim3(grid), dim3(THREADS), args, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixdq_sec_attention_qkv(const int8_t* x, const int8_t* w,
                                       const float* scale,
                                       const float* bias0, void* ws,
                                       int8_t* out, int B, int T, int C,
                                       int heads, int d, float sm_scale,
                                       float sinv, float zp, float lo,
                                       float hi, cudaStream_t stream) {
  const QkvArgs a{x, w, scale, bias0, static_cast<bf16*>(ws), out, B, T, C,
                  heads, sm_scale, Quant{sinv, zp, lo, hi}, vec16(x, C),
                  vec16(w, 3 * C)};
  switch (d) {
    case 16: return launch_qkv<16>(a, stream);
    case 32: return launch_qkv<32>(a, stream);
    case 64: return launch_qkv<64>(a, stream);
    case 128: return launch_qkv<128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// sec_attention_q_out
// ---------------------------------------------------------------------------

template <typename T>
struct QOutArgs {
  const T* x;  // raw input (LN-folded mode; also the residual) or null
  const float* gamma;
  const float* beta;
  const int8_t* wq;  // [C_in, C]
  const float* sq;
  const float* b0q;
  const T* k;  // key 0, column k_off, of batch element 0
  const T* v;
  int ldk, ldv;
  const int8_t* wout;  // [C, C_in]
  const float* so;
  const float* b0o;
  const float* bo;   // [C_in] or null
  const T* res;      // [B*Tq, C_in] or null (pre-coded mode)
  int8_t* codes;     // [B*Tq, C_in]: written in LN-folded mode, else input
  T* q;              // [B*Tq, C] workspace
  int8_t* o;         // [B*Tq, C] workspace: to_out's codes
  T* out;            // [B*Tq, C_in]
  int B, Tq, Tk, Cin, heads, ln;
  float sm_scale, eps;
  Quant mq, xq;
  bool avec_x, bvec_q, bvec_o;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    sec_q_out_kernel(const QOutArgs<T> a) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  __shared__ __align__(16) char smem[smem_bytes<D, BF16>()];
  const int M = a.B * a.Tq, C = a.heads * D, Cin = a.Cin;
  cg::grid_group grid = cg::this_grid();
  if (a.ln) {  // pre-LayerNorm + to_q act-quantize, a warp per row
    ln_stage(a.x, a.gamma, a.beta, a.codes, M, Cin, a.xq.sinv, a.xq.zp,
             a.xq.lo, a.xq.hi, a.eps);
    grid.sync();
  }
  proj_stage<T>(smem, a.codes, M, Cin, a.avec_x, a.wq, C, a.bvec_q, a.sq,
                a.b0q, a.q);
  grid.sync();
  attn_stage<T, D>(smem, a.q, C, a.k, a.ldk, a.v, a.ldv, a.o, C, a.B, a.Tq,
                   a.Tk, a.heads, a.sm_scale, a.mq);
  grid.sync();
  // to_out + bias + residual (the raw input in LN-folded mode)
  out_stage<T>(reinterpret_cast<int8_t(*)[LDS]>(smem),
               reinterpret_cast<int8_t(*)[LDS]>(smem + BM * LDS), a.o, M, C,
               true, a.wout, Cin, a.bvec_o, a.so, a.b0o, a.bo,
               a.ln ? a.x : a.res, a.out);
}

template <typename T, int D>
static int launch_q_out(QOutArgs<T> a, cudaStream_t stream) {
  const int M = a.B * a.Tq, C = a.heads * D;
  const int tiles = std::max({tiles64(M, C), tiles64(M, a.Cin),
                              a.B * a.heads * ((a.Tq + 63) / 64)});
  const int grid = cooperative_grid(sec_q_out_kernel<T, D>, tiles);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sec_q_out_kernel<T, D>),
                              dim3(grid), dim3(THREADS), args, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int q_out(const void* x, const float* gamma, const float* beta,
                 const int8_t* wq, const float* sq, const float* b0q,
                 const void* k, const void* v, int ldk, int ldv,
                 const int8_t* wout, const float* so, const float* b0o,
                 const float* bo, const void* res, int8_t* codes, void* q,
                 int8_t* o, void* out, int B, int Tq, int Tk, int Cin,
                 int heads, int d, int ln, float sm_scale, Quant mq,
                 Quant xq, float eps, cudaStream_t stream) {
  const QOutArgs<T> a{
      static_cast<const T*>(x), gamma, beta, wq, sq, b0q,
      static_cast<const T*>(k), static_cast<const T*>(v), ldk, ldv, wout,
      so, b0o, bo, static_cast<const T*>(res), codes, static_cast<T*>(q), o,
      static_cast<T*>(out), B, Tq, Tk, Cin, heads, ln, sm_scale, eps, mq, xq,
      vec16(codes, Cin), vec16(wq, heads * d), vec16(wout, Cin)};
  switch (d) {
    case 16: return launch_q_out<T, 16>(a, stream);
    case 32: return launch_q_out<T, 32>(a, stream);
    case 64: return launch_q_out<T, 64>(a, stream);
    case 128: return launch_q_out<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_sec_attention_q_out(
    const void* x, const float* gamma, const float* beta, const int8_t* wq,
    const float* sq, const float* b0q, const void* k, const void* v, int ldk,
    int ldv, const int8_t* wout, const float* so, const float* b0o,
    const float* bo, const void* res, int8_t* codes, void* q, int8_t* o,
    void* out, int B, int Tq, int Tk, int Cin, int heads, int d, int is_bf16,
    int ln, float sm_scale, float mid_sinv, float mid_zp, float mid_lo,
    float mid_hi, float x_sinv, float x_zp, float x_lo, float x_hi, float eps,
    cudaStream_t stream) {
  const Quant mq{mid_sinv, mid_zp, mid_lo, mid_hi};
  const Quant xq{x_sinv, x_zp, x_lo, x_hi};
  auto fn = is_bf16 ? q_out<bf16> : q_out<float>;
  return fn(x, gamma, beta, wq, sq, b0q, k, v, ldk, ldv, wout, so, b0o, bo,
            res, codes, q, o, out, B, Tq, Tk, Cin, heads, d, ln, sm_scale,
            mq, xq, eps, stream);
}

// ---------------------------------------------------------------------------
// sec_attention_qkv_out
// ---------------------------------------------------------------------------

template <typename T>
struct QkvOutArgs {
  const T* x;  // raw input (LN-folded mode; also the residual) or null
  const float* gamma;
  const float* beta;
  int8_t* codes;  // [B*T, C]: written in LN-folded mode, else input
  const int8_t* w;  // [C, 3C]
  const float* scale;
  const float* bias0;  // [3C]
  bf16* ws;            // [B*T, 3C] workspace: q | k | v
  int8_t* o;           // [B*T, C] workspace: to_out's codes
  const int8_t* wout;  // [C, C]
  const float* so;
  const float* b0o;
  const float* bo;  // [C] or null
  const T* res;     // [B*T, C] or null (pre-coded mode)
  T* out;           // [B*T, C]
  int B, T_, heads, ln;
  float sm_scale, eps;
  Quant mq, xq;
  bool avec, bvec, bvec_o;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    sec_qkv_out_kernel(const QkvOutArgs<T> a) {
  __shared__ __align__(16) char smem[smem_bytes<D, true>()];
  const int M = a.B * a.T_, C = a.heads * D, N = 3 * C;
  cg::grid_group grid = cg::this_grid();
  if (a.ln) {  // pre-LayerNorm + to_qkv act-quantize, a warp per row
    ln_stage(a.x, a.gamma, a.beta, a.codes, M, C, a.xq.sinv, a.xq.zp,
             a.xq.lo, a.xq.hi, a.eps);
    grid.sync();
  }
  proj_stage<bf16>(smem, a.codes, M, C, a.avec, a.w, N, a.bvec, a.scale,
                   a.bias0, a.ws);
  grid.sync();
  attn_stage<bf16, D>(smem, a.ws, N, a.ws + C, N, a.ws + 2 * C, N, a.o, C,
                      a.B, a.T_, a.T_, a.heads, a.sm_scale, a.mq);
  grid.sync();
  out_stage<T>(reinterpret_cast<int8_t(*)[LDS]>(smem),
               reinterpret_cast<int8_t(*)[LDS]>(smem + BM * LDS), a.o, M, C,
               true, a.wout, C, a.bvec_o, a.so, a.b0o, a.bo,
               a.ln ? a.x : a.res, a.out);
}

template <typename T, int D>
static int launch_qkv_out(QkvOutArgs<T> a, cudaStream_t stream) {
  const int M = a.B * a.T_, C = a.heads * D;
  const int tiles = std::max({tiles64(M, 3 * C), tiles64(M, C),
                              a.B * a.heads * ((a.T_ + 63) / 64)});
  const int grid = cooperative_grid(sec_qkv_out_kernel<T, D>, tiles);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sec_qkv_out_kernel<T, D>), dim3(grid),
      dim3(THREADS), args, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int qkv_out(const void* x, const float* gamma, const float* beta,
                   int8_t* codes, const int8_t* w, const float* scale,
                   const float* bias0, void* ws, int8_t* o,
                   const int8_t* wout, const float* so, const float* b0o,
                   const float* bo, const void* res, void* out, int B, int T_,
                   int heads, int d, int ln, float sm_scale, Quant mq,
                   Quant xq, float eps, cudaStream_t stream) {
  const int C = heads * d;
  const QkvOutArgs<T> a{
      static_cast<const T*>(x), gamma, beta, codes, w, scale, bias0,
      static_cast<bf16*>(ws), o, wout, so, b0o, bo,
      static_cast<const T*>(res), static_cast<T*>(out), B, T_, heads, ln,
      sm_scale, eps, mq, xq, vec16(codes, C), vec16(w, 3 * C),
      vec16(wout, C)};
  switch (d) {
    case 16: return launch_qkv_out<T, 16>(a, stream);
    case 32: return launch_qkv_out<T, 32>(a, stream);
    case 64: return launch_qkv_out<T, 64>(a, stream);
    case 128: return launch_qkv_out<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_sec_attention_qkv_out(
    const void* x, const float* gamma, const float* beta, int8_t* codes,
    const int8_t* w, const float* scale, const float* bias0, void* ws,
    int8_t* o, const int8_t* wout, const float* so, const float* b0o,
    const float* bo, const void* res, void* out, int B, int T_, int heads,
    int d, int is_bf16, int ln, float sm_scale, float mid_sinv, float mid_zp,
    float mid_lo, float mid_hi, float x_sinv, float x_zp, float x_lo,
    float x_hi, float eps, cudaStream_t stream) {
  const Quant mq{mid_sinv, mid_zp, mid_lo, mid_hi};
  const Quant xq{x_sinv, x_zp, x_lo, x_hi};
  auto fn = is_bf16 ? qkv_out<bf16> : qkv_out<float>;
  return fn(x, gamma, beta, codes, w, scale, bias0, ws, o, wout, so, b0o, bo,
            res, out, B, T_, heads, d, ln, sm_scale, mq, xq, eps, stream);
}
