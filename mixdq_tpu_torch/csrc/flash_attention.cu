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
