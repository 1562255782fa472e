// Flash attention of the attn_impl="auto" path at Tq * Tk >= 2^22 (the
// self-attentions of SDXL 1024's 64x64 level, in the W8A8 and the bf16
// UNet).
//
// Replaces mixdq_tpu/ops/pallas_attention.py:flash_attention (pallas_call
// at :106; mha :135 feeds it head-major copies). Per head, over key
// blocks of KC keys (Chunk<D>::KC: 64 for d <= 64, 32 for d = 128):
//
//   s = (q . k^T) * scale              f32, keys >= Tk masked to -1e30
//   m' = max(m, max_j s)               m starts at -1e30
//   alpha = exp(m - m'); p = exp(s - m')
//   l = l alpha + sum_j p              l from the f32 p
//   acc = acc alpha + bf16(p) . v      p cast to v's dtype, f32 acc
//   out = acc / l                      in q's dtype
//
// The TPU kernel carries m, l and acc in VMEM scratch along a sequential
// key grid axis. Here one block owns (batch, head, 64 query rows), warp w
// rows 16 w ..+16, and walks the key blocks in a loop with m, l and acc in
// registers; k and v of a key block are staged in shared memory (v
// transposed), and QK^T and PV run on mma.sync m16n8k16 (bf16 x bf16 ->
// f32). q/k/v are read in place at their column offsets with their
// sources' row strides (the fused to_qkv output), and the output is
// written [B, Tq, heads * d] for to_out: no head-major copies. f32 q/k/v
// take a scalar path, a warp per row.
//
// Bound at T=4096, 10 heads, d=64: 4 T^2 d heads = 43 GFLOP of bf16
// tensor-core work, ~0.043 ms at the dense peak; the bytes (q/k/v and
// out, ~21 MB) take ~6 us.
//
// int8_flash_attention and int8qkv_flash_attention (int8 self-attention
// sites at Tq * Tk >= 2^22 under QuantCtx.int8_flash "qk" / "qkv"; replace
// pallas_attention.py:int8_flash_attention, pallas_call at :228, body
// :165, and :int8qkv_flash_attention, :330, body :258): q and k arrive as
// per-tensor symmetric int8 codes (the wrapper quantizes them), QK^T runs
// on mma.sync m16n8k32 (s8 x s8 -> s32) and s = f32(s32) * logit_scale.
// int8_flash keeps PV in v's dtype (bf16 mma.sync on p cast to bf16, or
// the f32 scalar path for f32 v); int8qkv_flash takes v codes, quantizes
// p to round(127 p) in s8 and runs PV on mma.sync m16n8k32 too, with v
// transposed in shared memory in the key order of p's A fragments (the
// f32 accumulator layout of the logits holds keys 2t, 2t+1 of each 8;
// an s8 A fragment wants 4t..4t+3 of each 16, so the keys of a 32-key
// step are permuted, for v and p alike, and the sum is unchanged), then
// adds f32(pv) * s_v / 127 to the f32 accumulator. l sums the unquantized
// f32 p in both.
//
// The codes of p (and their bf16 rounding) are relative to the running
// max, so the key blocks are the TPU wrapper's: bk = 512 (clipped to Tk
// rounded up to 128). Each block takes its row max in a first pass over
// its 64-key chunks, rescales m, l and acc once, and forms p in a second
// pass that recomputes the same integer logits (the int8 QK^T runs twice;
// it is the cheaper product). Bounds at B=1 T=4096, 10 heads of 64, the
// matmul operations: int8_flash 21.5 GOP of int8 and 21.5 GFLOP of bf16,
// ~0.033 ms; int8qkv_flash 43 GOP of int8, ~0.022 ms.

#include <type_traits>

#include "attn_mma.cuh"

using namespace mixdq;

constexpr float MASKED = -1e30f;

template <typename T>
struct FlashArgs {
  const T* q;  // row 0, column q_off, of batch element 0
  const T* k;
  const T* v;
  T* out;  // [B*Tq, heads*D]
  int ldq, ldk, ldv, B, Tq, Tk, heads;
  float scale;
};

// One head over bf16 q/k/v for a 64-row tile (nq valid rows) into out
// (the tile's first row, the head's first column; row stride ldo).
template <int D>
__device__ void flash_bf16(void* smem, const HeadPanels<bf16>& h, bf16* out,
                           int ldq, int ldk, int ldv, int ldo, int nq, int Tk,
                           float scale) {
  constexpr int KC = Chunk<D>::KC;
  Chunk<D>& sm = *static_cast<Chunk<D>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows

  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, h.q, ldq, ra, rb, nq, t);

  float s[KC / 8][4];
  float o[D / 8][4] = {};
  // running max of rows ra / rb (the same in the row's four threads) and
  // this thread's share of their running sums
  float ma = MASKED, mb = MASKED, la = 0.f, lb = 0.f;
  for (int c0 = 0; c0 < Tk; c0 += KC) {
    load_chunk<D>(sm, h, ldk, ldv, Tk, c0, true);
    __syncthreads();
    chunk_logits<D>(sm, qf, s, g, t);
    float ca = MASKED, cb = MASKED;
#pragma unroll
    for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool in = c0 + nt * 8 + 2 * t + (r & 1) < Tk;
        const float v = in ? __fmul_rn(s[nt][r], scale) : MASKED;
        s[nt][r] = v;
        if (r < 2) ca = fmaxf(ca, v);
        else cb = fmaxf(cb, v);
      }
    const float na = fmaxf(ma, quad_max(ca)), nb = fmaxf(mb, quad_max(cb));
    const float aa = expf(__fsub_rn(ma, na)), ab = expf(__fsub_rn(mb, nb));
    ma = na;
    mb = nb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = expf(__fsub_rn(s[nt][r], r < 2 ? na : nb));
        s[nt][r] = p;
        if (r < 2) sa += p;
        else sb += p;
      }
    la = __fadd_rn(__fmul_rn(la, aa), sa);
    lb = __fadd_rn(__fmul_rn(lb, ab), sb);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] = __fmul_rn(o[dt][0], aa);
      o[dt][1] = __fmul_rn(o[dt][1], aa);
      o[dt][2] = __fmul_rn(o[dt][2], ab);
      o[dt][3] = __fmul_rn(o[dt][3], ab);
    }
    chunk_pv<D>(sm, s, o, g, t);
    __syncthreads();
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int row = r < 2 ? ra : rb;
      if (row >= nq) continue;
      const float l = r < 2 ? la : lb;
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(row) * ldo + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(o[dt][r], l),
                                __fdiv_rn(o[dt][r + 1], l));
    }
}

// The same over f32 q/k/v for rows [0, nq) of q/out, by one warp, a row at
// a time: a lane per key for the logits, a lane per column for p.v.
template <int D>
__device__ void flash_f32(const float* q, const float* k, const float* v,
                          float* out, int ldq, int ldk, int ldv, int ldo,
                          int nq, int Tk, float scale) {
  constexpr int KC = Chunk<D>::KC, PL = KC / 32, NC = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nq; ++r) {
    const float* qr = q + static_cast<size_t>(r) * ldq;
    float m = MASKED, l = 0.f, o[NC] = {};
    for (int c0 = 0; c0 < Tk; c0 += KC) {
      float p[PL], cm = MASKED;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int j = c0 + 32 * i + lane;
        p[i] = j < Tk ? __fmul_rn(dot_f32(qr, k + static_cast<size_t>(j) * ldk,
                                          D),
                                  scale)
                      : MASKED;
        cm = fmaxf(cm, p[i]);
      }
      const float nm = fmaxf(m, warp_max(cm));
      const float alpha = expf(__fsub_rn(m, nm));
      m = nm;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        p[i] = expf(__fsub_rn(p[i], nm));
        ps += p[i];
      }
      l = __fadd_rn(__fmul_rn(l, alpha), warp_sum(ps));
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c] = __fmul_rn(o[c], alpha);
#pragma unroll
      for (int i = 0; i < PL; ++i)
        for (int jj = 0; jj < 32 && c0 + 32 * i + jj < Tk; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p[i], jj);
          const float* vr = v + static_cast<size_t>(c0 + 32 * i + jj) * ldv;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (lane + 32 * c < D) o[c] += pj * vr[lane + 32 * c];
        }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < D)
        out[static_cast<size_t>(r) * ldo + lane + 32 * c] = __fdiv_rn(o[c], l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(const FlashArgs<T> a) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  __shared__ __align__(16) char smem[BF16 ? sizeof(Chunk<D>) : 16];
  const int rt = (a.Tq + 63) / 64, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * 64;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(64, a.Tq - r * 64), ldo = a.heads * D;
  if constexpr (BF16) {
    const HeadPanels<bf16> hp{a.q + row0 * a.ldq + h * D,
                              a.k + key0 * a.ldk + h * D,
                              a.v + key0 * a.ldv + h * D, nullptr};
    flash_bf16<D>(smem, hp, a.out + row0 * ldo + h * D, a.ldq, a.ldk, a.ldv,
                  ldo, nq, a.Tk, a.scale);
  } else {  // a warp per 16 rows
    const size_t w0 = row0 + (threadIdx.x >> 5) * 16;
    flash_f32<D>(a.q + w0 * a.ldq + h * D, a.k + key0 * a.ldk + h * D,
                 a.v + key0 * a.ldv + h * D, a.out + w0 * ldo + h * D, a.ldq,
                 a.ldk, a.ldv, ldo,
                 max(0, min(16, nq - static_cast<int>(threadIdx.x >> 5) * 16)),
                 a.Tk, a.scale);
  }
}

template <typename T, int D>
static int launch_flash(const FlashArgs<T>& a, cudaStream_t stream) {
  const int grid = a.B * a.heads * ((a.Tq + 63) / 64);
  flash_kernel<T, D><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int flash(const void* q, const void* k, const void* v, void* out,
                 int ldq, int ldk, int ldv, int B, int Tq, int Tk, int heads,
                 int d, float scale, cudaStream_t stream) {
  const FlashArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(out), ldq,
                       ldk, ldv, B, Tq, Tk, heads, scale};
  switch (d) {
    case 16: return launch_flash<T, 16>(a, stream);
    case 32: return launch_flash<T, 32>(a, stream);
    case 64: return launch_flash<T, 64>(a, stream);
    case 128: return launch_flash<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int ldq,
                                     int ldk, int ldv, int B, int Tq, int Tk,
                                     int heads, int d, int is_bf16,
                                     float scale, cudaStream_t stream) {
  auto fn = is_bf16 ? flash<bf16> : flash<float>;
  return fn(q, k, v, out, ldq, ldk, ldv, B, Tq, Tk, heads, d, scale, stream);
}

// ---------------------------------------------------------------------------
// int8_flash_attention / int8qkv_flash_attention
// ---------------------------------------------------------------------------

constexpr int KC8 = 64;  // keys per shared-memory chunk

// One chunk of keys: k codes [key][d] (rows padded to a 32-deep mma step,
// +16 bytes against bank conflicts) and v transposed, [d][key]: bf16 in
// key order, or s8 codes in each 32-key step's A-fragment order.
template <int D, bool V8>
struct I8Chunk {
  static constexpr int DP = D < 32 ? 32 : D;
  int8_t k[KC8][DP + 16];
  typename std::conditional<V8, int8_t, bf16>::type vt[D][KC8 + (V8 ? 16 : 8)];
};

// The k index of local key q (0..31) in an s8 A fragment built from the
// logits' accumulator layout: tile nt = q / 8 holds keys 2t, 2t+1.
__device__ __forceinline__ int s8_slot(int q) {
  const int nt = q >> 3, w = q & 7;
  return (nt >> 1) * 16 + (w >> 1) * 4 + (nt & 1) * 2 + (w & 1);
}

struct I8Args {
  const int8_t* q;  // [B*Tq, heads*D] codes
  const int8_t* k;  // [B*Tk, heads*D] codes
  const void* v;    // row 0 of the v panel (ldv), or codes [B*Tk, heads*D]
  void* out;        // [B*Tq, heads*D]
  int ldv, B, Tq, Tk, heads, bk;
  // device scalars, so that no launch waits for the quantize: s_q s_k
  // d^-1/2; s_v / 127 (int8 v) or null
  const float* ls;
  const float* vs;
};

// Block-wide: keys [c0, c0 + KC8) of k (and v) into shared memory, 16-byte
// loads; keys >= Tk read as zero.
template <int D, bool V8, typename TV>
__device__ __forceinline__ void load_i8_chunk(I8Chunk<D, V8>& sm,
                                              const int8_t* k, int ldk,
                                              const TV* v, int ldv, int Tk,
                                              int c0, bool with_v) {
  for (int i = threadIdx.x; i < KC8 * D / 16; i += blockDim.x) {
    const int key = i / (D / 16), c = (i % (D / 16)) * 16;
    int4 u = make_int4(0, 0, 0, 0);
    if (c0 + key < Tk)
      u = *reinterpret_cast<const int4*>(k + static_cast<size_t>(c0 + key) *
                                                 ldk + c);
    *reinterpret_cast<int4*>(&sm.k[key][c]) = u;
  }
  if (!with_v) return;
  constexpr int PER = 16 / static_cast<int>(sizeof(TV));  // per 16 bytes
  for (int i = threadIdx.x; i < KC8 * D / PER; i += blockDim.x) {
    const int key = i / (D / PER), c = (i % (D / PER)) * PER;
    int4 u = make_int4(0, 0, 0, 0);
    if (c0 + key < Tk)
      u = *reinterpret_cast<const int4*>(v + static_cast<size_t>(c0 + key) *
                                                 ldv + c);
    const TV* e = reinterpret_cast<const TV*>(&u);
    const int slot = V8 ? (key & ~31) + s8_slot(key & 31) : key;
#pragma unroll
    for (int j = 0; j < PER; ++j) sm.vt[c + j][slot] = e[j];
  }
}

// The warp's 16 x KC8 integer logits of one chunk.
template <int D, bool V8>
__device__ __forceinline__ void chunk_logits_s8(
    const I8Chunk<D, V8>& sm, const int (&qf)[I8Chunk<D, V8>::DP / 32][4],
    int (&s)[KC8 / 8][4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < KC8 / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
#pragma unroll
    for (int kk = 0; kk < I8Chunk<D, V8>::DP / 32; ++kk) {
      const int8_t* kr = &sm.k[nt * 8 + g][kk * 32 + t * 4];
      const int b[2] = {*reinterpret_cast<const int*>(kr),
                        *reinterpret_cast<const int*>(kr + 16)};
      mma_s8(s[nt], qf[kk], b);
    }
  }
}

__device__ __forceinline__ int pack_s8(float a, float b, float c, float d) {
  return static_cast<int>(static_cast<uint32_t>(__float2int_rn(a)) & 0xff) |
         static_cast<int>((static_cast<uint32_t>(__float2int_rn(b)) & 0xff)
                          << 8) |
         static_cast<int>((static_cast<uint32_t>(__float2int_rn(c)) & 0xff)
                          << 16) |
         static_cast<int>(static_cast<uint32_t>(__float2int_rn(d)) << 24);
}

// One head over q/k codes for a 64-row tile (nq valid rows), PV on the
// tensor cores: bf16 v (p cast to bf16) or s8 v codes (p as round(127 p)).
template <int D, bool V8, typename TV, typename TO>
__device__ void int8_flash_mma(void* smem, const int8_t* q, const int8_t* k,
                               const TV* v, TO* out, int ld, int ldv, int nq,
                               int Tk, int bk, float ls, float vs) {
  using Sm = I8Chunk<D, V8>;
  constexpr int DP = Sm::DP;
  Sm& sm = *static_cast<Sm*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;

  int qf[DP / 32][4];
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i & 1 ? rb : ra, c = kk * 32 + (i >> 1) * 16 + t * 4;
      qf[kk][i] = row < nq && c < D ? *reinterpret_cast<const int*>(
                                          q + static_cast<size_t>(row) * ld + c)
                                    : 0;
    }

  int s32[KC8 / 8][4];
  float p[KC8 / 8][4];
  float o[D / 8][4] = {};
  float ma = MASKED, mb = MASKED, la = 0.f, lb = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += bk) {
    const int jend = min(j0 + bk, Tk);
    float ca = MASKED, cb = MASKED;  // pass 1: the block's row max
    for (int c0 = j0; c0 < jend; c0 += KC8) {
      load_i8_chunk<D, V8, TV>(sm, k, ld, v, ldv, Tk, c0, false);
      __syncthreads();
      chunk_logits_s8<D, V8>(sm, qf, s32, g, t);
#pragma unroll
      for (int nt = 0; nt < KC8 / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (c0 + nt * 8 + 2 * t + (r & 1) >= Tk) continue;
          const float x = __fmul_rn(__int2float_rn(s32[nt][r]), ls);
          if (r < 2) ca = fmaxf(ca, x);
          else cb = fmaxf(cb, x);
        }
      __syncthreads();
    }
    const float na = fmaxf(ma, quad_max(ca)), nb = fmaxf(mb, quad_max(cb));
    const float aa = expf(__fsub_rn(ma, na)), ab = expf(__fsub_rn(mb, nb));
    ma = na;
    mb = nb;
    la = __fmul_rn(la, aa);
    lb = __fmul_rn(lb, ab);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] = __fmul_rn(o[dt][0], aa);
      o[dt][1] = __fmul_rn(o[dt][1], aa);
      o[dt][2] = __fmul_rn(o[dt][2], ab);
      o[dt][3] = __fmul_rn(o[dt][3], ab);
    }
    int pv[V8 ? D / 8 : 1][4] = {};
    for (int c0 = j0; c0 < jend; c0 += KC8) {  // pass 2: p, l, p.v
      load_i8_chunk<D, V8, TV>(sm, k, ld, v, ldv, Tk, c0, true);
      __syncthreads();
      chunk_logits_s8<D, V8>(sm, qf, s32, g, t);
#pragma unroll
      for (int nt = 0; nt < KC8 / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = 0.f;
          if (c0 + nt * 8 + 2 * t + (r & 1) < Tk)
            x = expf(__fsub_rn(__fmul_rn(__int2float_rn(s32[nt][r]), ls),
                               r < 2 ? na : nb));
          p[nt][r] = x;
          if (r < 2) la += x;
          else lb += x;
        }
      if constexpr (V8) {
#pragma unroll
        for (int kb = 0; kb < KC8 / 32; ++kb) {
          float c[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              c[i][r] = rintf(__fmul_rn(p[4 * kb + i][r], 127.f));
          const int pa[4] = {pack_s8(c[0][0], c[0][1], c[1][0], c[1][1]),
                             pack_s8(c[0][2], c[0][3], c[1][2], c[1][3]),
                             pack_s8(c[2][0], c[2][1], c[3][0], c[3][1]),
                             pack_s8(c[2][2], c[2][3], c[3][2], c[3][3])};
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const int8_t* vr = &sm.vt[dt * 8 + g][kb * 32 + t * 4];
            const int b[2] = {*reinterpret_cast<const int*>(vr),
                              *reinterpret_cast<const int*>(vr + 16)};
            mma_s8(pv[dt], pa, b);
          }
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < KC8 / 16; ++kb) {
          const uint32_t pa[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                                  pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                                  pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                                  pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const bf16* vr = &sm.vt[dt * 8 + g][kb * 16 + 2 * t];
            mma_bf16(o[dt], pa, ld32(vr), ld32(vr + 8));
          }
        }
      }
      __syncthreads();
    }
    if constexpr (V8) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          o[dt][r] = __fadd_rn(o[dt][r],
                               __fmul_rn(__int2float_rn(pv[dt][r]), vs));
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r < 2 ? ra : rb;
      if (row >= nq) continue;
      store_f32(out + static_cast<size_t>(row) * ld + dt * 8 + 2 * t + (r & 1),
                __fdiv_rn(o[dt][r], r < 2 ? la : lb));
    }
}

__device__ __forceinline__ int dot_s8(const int8_t* a, const int8_t* b,
                                      int n) {
  int s = 0;
  for (int i = 0; i < n; i += 4)
    s = __dp4a(*reinterpret_cast<const int*>(a + i),
               *reinterpret_cast<const int*>(b + i), s);
  return s;
}

// int8_flash over f32 v, rows [0, nq) of q/out, by one warp, a row at a
// time: a lane per key for the logits, a lane per column for p.v.
template <int D>
__device__ void int8_flash_f32(const int8_t* q, const int8_t* k,
                               const float* v, float* out, int ld, int ldv,
                               int nq, int Tk, int bk, float ls) {
  constexpr int NC = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nq; ++r) {
    const int8_t* qr = q + static_cast<size_t>(r) * ld;
    float m = MASKED, l = 0.f, o[NC] = {};
    for (int j0 = 0; j0 < Tk; j0 += bk) {
      const int jend = min(j0 + bk, Tk);
      float cm = MASKED;
      for (int j = j0 + lane; j < jend; j += 32)
        cm = fmaxf(cm, __fmul_rn(__int2float_rn(dot_s8(
                                     qr, k + static_cast<size_t>(j) * ld, D)),
                                 ls));
      const float nm = fmaxf(m, warp_max(cm));
      const float alpha = expf(__fsub_rn(m, nm));
      m = nm;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c] = __fmul_rn(o[c], alpha);
      float ps = 0.f;
      for (int j1 = j0; j1 < jend; j1 += 32) {
        const int j = j1 + lane;
        float pj = 0.f;
        if (j < jend)
          pj = expf(__fsub_rn(
              __fmul_rn(__int2float_rn(dot_s8(
                            qr, k + static_cast<size_t>(j) * ld, D)),
                        ls),
              nm));
        ps += pj;
        for (int jj = 0; jj < 32 && j1 + jj < jend; ++jj) {
          const float pb = __shfl_sync(0xffffffffu, pj, jj);
          const float* vr = v + static_cast<size_t>(j1 + jj) * ldv;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (lane + 32 * c < D) o[c] += pb * vr[lane + 32 * c];
        }
      }
      l = __fadd_rn(__fmul_rn(l, alpha), warp_sum(ps));
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < D)
        out[static_cast<size_t>(r) * ld + lane + 32 * c] = __fdiv_rn(o[c], l);
  }
}

template <typename TV, typename TO, int D, bool V8>
__global__ void __launch_bounds__(THREADS) int8_flash_kernel(const I8Args a) {
  constexpr bool SCALAR = std::is_same<TV, float>::value;
  __shared__ __align__(16) char smem[SCALAR ? 16 : sizeof(I8Chunk<D, V8>)];
  const int rt = (a.Tq + 63) / 64, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const int ld = a.heads * D;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * 64;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(64, a.Tq - r * 64);
  const float ls = *a.ls, vs = V8 ? *a.vs : 0.f;
  const int8_t* k = a.k + key0 * ld + h * D;
  const TV* v = static_cast<const TV*>(a.v) + key0 * a.ldv + h * D;
  TO* out = static_cast<TO*>(a.out);
  if constexpr (SCALAR) {  // a warp per 16 rows
    const size_t w0 = row0 + (threadIdx.x >> 5) * 16;
    int8_flash_f32<D>(a.q + w0 * ld + h * D, k, v,
                      reinterpret_cast<float*>(out) + w0 * ld + h * D, ld,
                      a.ldv,
                      max(0, min(16, nq - static_cast<int>(threadIdx.x >> 5) *
                                              16)),
                      a.Tk, a.bk, ls);
  } else {
    int8_flash_mma<D, V8, TV, TO>(smem, a.q + row0 * ld + h * D, k, v,
                                  out + row0 * ld + h * D, ld, a.ldv, nq,
                                  a.Tk, a.bk, ls, vs);
  }
}

template <typename TV, typename TO, bool V8>
static int launch_int8_flash(const I8Args& a, int d, cudaStream_t stream) {
  const int grid = a.B * a.heads * ((a.Tq + 63) / 64);
  switch (d) {
    case 16: int8_flash_kernel<TV, TO, 16, V8><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 32: int8_flash_kernel<TV, TO, 32, V8><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 64: int8_flash_kernel<TV, TO, 64, V8><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 128:
      int8_flash_kernel<TV, TO, 128, V8><<<grid, THREADS, 0, stream>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixdq_int8_flash_attention(const int8_t* q, const int8_t* k,
                                          const void* v, void* out, int ldv,
                                          int B, int Tq, int Tk, int heads,
                                          int d, int bk, int int8_v,
                                          int v_bf16, int out_bf16,
                                          const float* ls, const float* vs,
                                          cudaStream_t stream) {
  const I8Args a{q, k, v, out, ldv, B, Tq, Tk, heads, bk, ls, vs};
  if (int8_v)
    return out_bf16 ? launch_int8_flash<int8_t, bf16, true>(a, d, stream)
                    : launch_int8_flash<int8_t, float, true>(a, d, stream);
  if (v_bf16 != out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return v_bf16 ? launch_int8_flash<bf16, bf16, false>(a, d, stream)
                : launch_int8_flash<float, float, false>(a, d, stream);
}
