// bf16 mma.sync building blocks shared by the attention kernels
// (sec_attention.cu, flash_attention.cu): a warp owns 16 query rows of one
// head; keys stream through a cp.async ring in shared memory, QK^T and PV
// run on mma.sync m16n8k16 (bf16 x bf16 -> f32).
#pragma once

#include "cp_async.cuh"
#include "mma_s8.cuh"

namespace mixdq {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One head's panels for a row tile: q/out at the tile's first row, k/v at
// key 0, all at the head's first column (out: int8 codes, or null where
// the kernel writes its own output).
template <typename T>
struct HeadPanels {
  const T* q;
  const T* k;
  const T* v;
  int8_t* out;
};

// The warp's q rows ra and rb (ra + 8) as mma A fragments; rows >= nq
// read as zero.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const bf16* q, int ldq, int ra,
                                             int rb, int nq, int t) {
  const bool oka = ra < nq, okb = rb < nq;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = oka ? ld32(q + static_cast<size_t>(ra) * ldq + c) : 0u;
    qf[kk][1] = okb ? ld32(q + static_cast<size_t>(rb) * ldq + c) : 0u;
    qf[kk][2] = oka ? ld32(q + static_cast<size_t>(ra) * ldq + c + 8) : 0u;
    qf[kk][3] = okb ? ld32(q + static_cast<size_t>(rb) * ldq + c + 8) : 0u;
  }
}

// The key ring of the bf16 attention kernels (flash_attention.cu's bf16
// path, sec_attention.cu's attention stage): a group of 4 warps (128
// threads) owns 64 query rows of one head, warp w rows 16 w ..+16, and
// streams k and v through ring stages of KCH keys in shared memory, filled
// by cp.async (cp_async.cuh). A stage holds the chunk's k rows, then its v
// rows, each padded by 8 bf16 (16 bytes) so that the 8 row addresses of an
// ldmatrix land in distinct banks. k fragments come from ldmatrix.x4; v
// stays row-major and PV's B fragments come from ldmatrix.x4.trans.
constexpr int KCH = 32;          // keys per ring stage
constexpr int GROUP_THREADS = 128;  // threads that fill and read one ring

template <int D>
struct KvStage {
  static constexpr int LD = D + 8;                 // padded row, bf16
  static constexpr int BYTES = 2 * KCH * LD * 2;  // k rows, then v rows
};

// Keys [c0, c0 + KCH) of k (and of v when with_v) into the ring stage at
// shared address st, thread gtid of the group's 128 taking its share of
// the 16-byte copies; keys >= Tk read as zero. The caller commits.
template <int D>
__device__ __forceinline__ void copy_kv_chunk(uint32_t st,
                                              const HeadPanels<bf16>& h,
                                              int ldk, int ldv, int Tk,
                                              int c0, bool with_v,
                                              int gtid) {
  constexpr int CPR = D / 8, N = KCH * CPR, LD = KvStage<D>::LD;
#pragma unroll
  for (int it = 0; it < (N + GROUP_THREADS - 1) / GROUP_THREADS; ++it) {
    const int i = gtid + it * GROUP_THREADS;
    if (N % GROUP_THREADS == 0 || i < N) {
      const int key = i / CPR, c = (i % CPR) * 8;
      const bool ok = c0 + key < Tk;
      const size_t j = ok ? c0 + key : 0;
      cp_async16(st + (key * LD + c) * 2, h.k + j * ldk + c, ok);
      if (with_v)
        cp_async16(st + ((KCH + key) * LD + c) * 2, h.v + j * ldv + c, ok);
    }
  }
}

// The warp's 16 x KCH logits of one stage (unscaled): A = q fragments,
// B = k rows by ldmatrix.x4 (two key tiles of 8 per load).
template <int D>
__device__ __forceinline__ void ring_logits(uint32_t st,
                                            const uint32_t (&qf)[D / 16][4],
                                            float (&s)[KCH / 8][4],
                                            int lane) {
  constexpr int LD = KvStage<D>::LD;
  const uint32_t kb =
      st + (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int nt = 0; nt < KCH / 8; nt += 2) {
    // the key pair's fragments at every depth first, then the products
    uint32_t b[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(b[kk], kb + (nt * 8 * LD + kk * 16) * 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = s[nt + 1][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_bf16(s[nt], qf[kk], b[kk][0], b[kk][1]);
      mma_bf16(s[nt + 1], qf[kk], b[kk][2], b[kk][3]);
    }
  }
}

// o += bf16(p) . v over one stage: p in the layout of ring_logits, cast
// to bf16 as the A fragments (the TPU's p.astype(v.dtype)); v's B
// fragments by ldmatrix.x4.trans (two column tiles of 8 per load). The
// keys go in ascending 16-key mma steps.
template <int D>
__device__ __forceinline__ void ring_pv(uint32_t st,
                                        const float (&p)[KCH / 8][4],
                                        float (&o)[D / 8][4], int lane) {
  constexpr int LD = KvStage<D>::LD;
  const uint32_t vb =
      st + ((KCH + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) *
               2;
#pragma unroll
  for (int kb = 0; kb < KCH / 16; ++kb) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                            pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                            pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                            pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
    uint32_t b[D / 16][4];
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp)
      ldsm_x4_trans(b[dp], vb + (kb * 16 * LD + dp * 16) * 2);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      mma_bf16(o[2 * dp], pa, b[dp][0], b[dp][1]);
      mma_bf16(o[2 * dp + 1], pa, b[dp][2], b[dp][3]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b,
                                         int n) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

}  // namespace mixdq
