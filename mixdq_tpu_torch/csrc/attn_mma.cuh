// mma.sync building blocks shared by the attention kernels
// (sec_attention.cu, flash_attention.cu, int8_flash.cu): a warp owns 16
// query rows of one head; keys stream through a cp.async ring in shared
// memory, QK^T and PV run on mma.sync m16n8k16 (bf16 x bf16 -> f32), or
// QK^T on m16n8k32 (s8 x s8 -> s32) over int8 codes.
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

//
// A head dim that is no multiple of 16 (40, 80 is one) is padded to DP,
// the next multiple of the mma's 16-deep step: the copies zero-fill
// columns [D, DP) of every k and v row in every stage, and the q
// fragments read those columns as zero, so they add nothing to QK^T; PV
// computes DP output columns, of which the caller writes D.
template <int D>
struct KvStage {
  static constexpr int DP = (D + 15) / 16 * 16;   // padded depth, bf16
  static constexpr int LD = DP + 8;                // padded row, bf16
  static constexpr int V = KCH * LD * 2;           // bytes before v rows
  static constexpr int BYTES = 2 * V;             // k rows, then v rows
};

// The warp's q rows ra and rb (ra + 8) as mma A fragments over the
// padded depth; rows >= nq and columns >= D read as zero.
template <int D>
__device__ __forceinline__ void load_q_frags(
    uint32_t (&qf)[KvStage<D>::DP / 16][4], const bf16* q, int ldq, int ra,
    int rb, int nq, int t) {
  const bool oka = ra < nq, okb = rb < nq;
#pragma unroll
  for (int kk = 0; kk < KvStage<D>::DP / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool hi = kk * 16 + 8 < D;  // columns c + 8 exist
    qf[kk][0] = oka ? ld32(q + static_cast<size_t>(ra) * ldq + c) : 0u;
    qf[kk][1] = okb ? ld32(q + static_cast<size_t>(rb) * ldq + c) : 0u;
    qf[kk][2] =
        oka && hi ? ld32(q + static_cast<size_t>(ra) * ldq + c + 8) : 0u;
    qf[kk][3] =
        okb && hi ? ld32(q + static_cast<size_t>(rb) * ldq + c + 8) : 0u;
  }
}

// Keys [c0, c0 + KCH) of k (and of v when with_v) into the ring stage at
// shared address st, thread gtid of the group's 128 taking its share of
// the 16-byte copies over the padded depth; keys >= Tk and columns >= D
// read as zero. The caller commits.
template <int D>
__device__ __forceinline__ void copy_kv_chunk(uint32_t st,
                                              const HeadPanels<bf16>& h,
                                              int ldk, int ldv, int Tk,
                                              int c0, bool with_v,
                                              int gtid) {
  constexpr int CPR = KvStage<D>::DP / 8, N = KCH * CPR;
  constexpr int LD = KvStage<D>::LD;
#pragma unroll
  for (int it = 0; it < (N + GROUP_THREADS - 1) / GROUP_THREADS; ++it) {
    const int i = gtid + it * GROUP_THREADS;
    if (N % GROUP_THREADS == 0 || i < N) {
      const int key = i / CPR, c = (i % CPR) * 8;
      const bool ok = c0 + key < Tk && (D % 16 == 0 || c < D);
      const size_t j = c0 + key < Tk ? c0 + key : 0;
      const int cs = D % 16 == 0 || c < D ? c : 0;  // a mapped source
      cp_async16(st + (key * LD + c) * 2, h.k + j * ldk + cs, ok);
      if (with_v)
        cp_async16(st + ((KCH + key) * LD + c) * 2, h.v + j * ldv + cs, ok);
    }
  }
}

// The warp's 16 x KCH logits of one stage (unscaled): A = q fragments,
// B = k rows by ldmatrix.x4 (two key tiles of 8 per load).
template <int D>
__device__ __forceinline__ void ring_logits(
    uint32_t st, const uint32_t (&qf)[KvStage<D>::DP / 16][4],
    float (&s)[KCH / 8][4], int lane) {
  constexpr int LD = KvStage<D>::LD, DP = KvStage<D>::DP;
  const uint32_t kb =
      st + (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int nt = 0; nt < KCH / 8; nt += 2) {
    // the key pair's fragments at every depth first, then the products
    uint32_t b[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(b[kk], kb + (nt * 8 * LD + kk * 16) * 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = s[nt + 1][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_bf16(s[nt], qf[kk], b[kk][0], b[kk][1]);
      mma_bf16(s[nt + 1], qf[kk], b[kk][2], b[kk][3]);
    }
  }
}

// o += bf16(p) . v over one stage: p in the layout of ring_logits, cast
// to bf16 as the A fragments (the TPU's p.astype(v.dtype)); v's B
// fragments by ldmatrix.x4.trans (two column tiles of 8 per load) from
// the stage's KCH row-major v rows at shared address vr, rows of
// KvStage<D>::LD bf16, over the padded depth. The keys go in ascending
// 16-key mma steps.
template <int D>
__device__ __forceinline__ void ring_pv(uint32_t vr,
                                        const float (&p)[KCH / 8][4],
                                        float (&o)[KvStage<D>::DP / 8][4],
                                        int lane) {
  constexpr int LD = KvStage<D>::LD, DP = KvStage<D>::DP;
  const uint32_t vb =
      vr + (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kb = 0; kb < KCH / 16; ++kb) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                            pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                            pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                            pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
    uint32_t b[DP / 16][4];
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp)
      ldsm_x4_trans(b[dp], vb + (kb * 16 * LD + dp * 16) * 2);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      mma_bf16(o[2 * dp], pa, b[dp][0], b[dp][1]);
      mma_bf16(o[2 * dp + 1], pa, b[dp][2], b[dp][3]);
    }
  }
}

// The warp's 16 x KCH integer logits of one stage of k codes (KCH rows of
// LDK bytes at shared address kr, DP codes deep, DP a multiple of 32):
// A = q code fragments, B = k rows by ldmatrix.x4. A 16-byte row read as
// 8 b16 gives each lane the 4 consecutive codes an m16n8k32 B fragment
// wants; one load is two key tiles of 8 at one 32-deep step.
template <int DP, int LDK>
__device__ __forceinline__ void ring_logits_s8(uint32_t kr,
                                               const int (&qf)[DP / 32][4],
                                               int (&s)[KCH / 8][4],
                                               int lane) {
  const uint32_t kb =
      kr + ((lane & 7) + (lane >> 4) * 8) * LDK + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int nt = 0; nt < KCH / 8; nt += 2) {
    uint32_t b[DP / 32][4];
#pragma unroll
    for (int kk = 0; kk < DP / 32; ++kk)
      ldsm_x4(b[kk], kb + nt * 8 * LDK + kk * 32);
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = s[nt + 1][r] = 0;
#pragma unroll
    for (int kk = 0; kk < DP / 32; ++kk) {
      const int b0[2] = {static_cast<int>(b[kk][0]),
                         static_cast<int>(b[kk][1])};
      const int b1[2] = {static_cast<int>(b[kk][2]),
                         static_cast<int>(b[kk][3])};
      mma_s8(s[nt], qf[kk], b0);
      mma_s8(s[nt + 1], qf[kk], b1);
    }
  }
}

// Where a key ring's next fill comes from (flash_attention.cu's bf16 path,
// int8_flash.cu): chunk c0 of the key block at j0, pass 0 (k) or 1 (k and
// v); j0 >= Tk once every chunk is issued. Per key block the ring takes
// its chunks of k for the max pass, then the same chunks of k and v for
// the p pass.
struct ChunkCursor {
  int c0, j0, pass;
  __device__ __forceinline__ void next(int Tk, int bk) {
    c0 += KCH;
    if (c0 < min(j0 + bk, Tk)) return;
    if (pass == 0) {
      pass = 1;
      c0 = j0;
    } else {
      j0 += bk;
      c0 = j0;
      pass = 0;
    }
  }
};

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

// The running max before the first key block and a masked key's logit
// (the TPU kernels' -1e30).
constexpr float MASKED = -1e30f;

// The f32 scalar path of the flash kernels: rows [0, nq) of out by one
// warp, a row at a time, over key blocks of bk keys: a pass over the
// block's logits for its row max, then p, l and p.v (a lane per key for
// the logits, a lane per column for p.v). logit(r, j) is row r's scaled
// logit of key j.
template <int D, typename Logit>
__device__ void flash_rows_f32(Logit logit, const float* v, float* out,
                               int ldv, int ldo, int nq, int Tk, int bk) {
  constexpr int NC = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nq; ++r) {
    float m = MASKED, l = 0.f, o[NC] = {};
    for (int j0 = 0; j0 < Tk; j0 += bk) {
      const int jend = min(j0 + bk, Tk);
      float cm = MASKED;
      for (int j = j0 + lane; j < jend; j += 32) cm = fmaxf(cm, logit(r, j));
      const float nm = fmaxf(m, warp_max(cm));
      const float alpha = expf(__fsub_rn(m, nm));
      m = nm;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c] = __fmul_rn(o[c], alpha);
      float ps = 0.f;
      for (int j1 = j0; j1 < jend; j1 += 32) {
        const int j = j1 + lane;
        const float pj = j < jend ? expf(__fsub_rn(logit(r, j), nm)) : 0.f;
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
        out[static_cast<size_t>(r) * ldo + lane + 32 * c] = __fdiv_rn(o[c], l);
  }
}

}  // namespace mixdq
