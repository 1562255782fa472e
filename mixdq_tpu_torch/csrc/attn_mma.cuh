// bf16 mma.sync building blocks shared by the attention kernels
// (sec_attention.cu, flash_attention.cu): a warp owns 16 query rows of one
// head; keys stream through shared memory in chunks of KC, QK^T and PV run
// on mma.sync m16n8k16 (bf16 x bf16 -> f32).
#pragma once

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

// Keys per shared-memory chunk: rows of k and columns of the transposed v.
template <int D>
struct Chunk {
  static constexpr int KC = D <= 64 ? 64 : 32;
  bf16 k[KC][D + 8];   // +8: fragment loads hit 32 distinct banks
  bf16 vt[D][KC + 8];  // v transposed: PV's B fragments are key pairs
};

// Block-wide: keys [c0, c0 + KC) of k (and v) into shared memory,
// 16-byte loads; keys >= Tk read as zero.
template <int D>
__device__ __forceinline__ void load_chunk(Chunk<D>& sm,
                                           const HeadPanels<bf16>& h,
                                           int ldk, int ldv, int Tk, int c0,
                                           bool with_v) {
  constexpr int KC = Chunk<D>::KC;
  for (int i = threadIdx.x; i < KC * D / 8; i += blockDim.x) {
    const int key = i / (D / 8), c = (i % (D / 8)) * 8;
    int4 kv = make_int4(0, 0, 0, 0), vv = kv;
    if (c0 + key < Tk) {
      const size_t j = c0 + key;
      kv = *reinterpret_cast<const int4*>(h.k + j * ldk + c);
      if (with_v) vv = *reinterpret_cast<const int4*>(h.v + j * ldv + c);
    }
    *reinterpret_cast<int4*>(&sm.k[key][c]) = kv;
    if (with_v) {
      const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.vt[c + j][key] = e[j];
    }
  }
}

// The warp's 16 x KC logits of one chunk (unscaled): A = q fragments,
// B = k rows.
template <int D>
__device__ __forceinline__ void chunk_logits(
    const Chunk<D>& sm, const uint32_t (&qf)[D / 16][4],
    float (&s)[Chunk<D>::KC / 8][4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < Chunk<D>::KC / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* kr = &sm.k[nt * 8 + g][kk * 16 + 2 * t];
      mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
    }
  }
}

// o += bf16(p) . v over one chunk: p = the warp's 16 x KC probabilities
// in the layout of chunk_logits, cast to bf16 as the A fragments (the
// TPU's p.astype(v.dtype)), v from the transposed chunk.
template <int D>
__device__ __forceinline__ void chunk_pv(const Chunk<D>& sm,
                                         const float (&p)[Chunk<D>::KC / 8][4],
                                         float (&o)[D / 8][4], int g, int t) {
#pragma unroll
  for (int kb = 0; kb < Chunk<D>::KC / 16; ++kb) {
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
