// int8_flash_attention and int8qkv_flash_attention: int8 self-attention at
// Tq * Tk >= 2^22 under QuantCtx.int8_flash "qk" / "qkv" (the 10 attn1
// sites of SDXL 1024's 64x64 level).
//
// Replace mixdq_tpu/ops/pallas_attention.py:int8_flash_attention (:204,
// pallas_call at :228, body :165) and :int8qkv_flash_attention (:303,
// :330, body :258). q and k arrive as per-tensor symmetric int8 codes
// (the wrapper quantizes them, and v for int8qkv). Per head, over key
// blocks of bk keys (the JAX wrappers' 512, clipped to Tk rounded up to
// 128: ops/attention.py:int8_block_keys):
//
//   s = f32(q . k^T in s32) * ls       keys >= Tk masked
//   m' = max(m, max_j s); alpha = exp(m - m'); p = exp(s - m')
//   l = l alpha + sum_j p              from the f32 p
//   int8_flash:    acc = acc alpha + bf16(p) . v
//   int8qkv_flash: acc = acc alpha + f32(sum_j round(127 p) v_codes) s_v/127
//                  (the s32 sum over the whole key block)
//   out = acc / l                      in v's dtype or out_dtype
//
// The codes of p (and its bf16 rounding) are relative to the running max,
// so the result depends on the key partition and the kernels keep the
// reference's.
//
// Bounds at B=1 T=4096, 10 heads of 64 (chip_smoke.py's phase 1 counts
// them): the int8 QK^T is 2 B T^2 C = 21.5 GOP, ~0.011 ms at the int8
// peak; PV another 2 B T^2 C, 21.5 GFLOP of bf16 (~0.022 ms) or 21.5 GOP
// of int8 (~0.011 ms); the bytes (codes, v and out, ~16-21 MB) ~6 us; the
// exact expf of 168 M logits runs beside the tensor cores on the SFU and
// ALU pipes. Per call a block of 64 query rows reads, through L2, k codes
// twice (2 x 256 KB) and v once (512 KB bf16 or 256 KB codes): 640 blocks
// read ~671 MB (int8_flash) or ~503 MB (int8qkv_flash).
//
// The design (the bf16 flash path's, flash_attention.cu): a block owns
// (batch, head, I8_ROWS = 64 query rows), warp w rows 16 w ..+16, its q
// code fragments in registers for both passes. k and v stream through a
// ring of I8_STAGES = 4 stages of KCH = 32 keys (one m16n8k32 step) in
// dynamic shared memory, filled by cp.async in the order the two passes
// read it (ChunkCursor: per key block its chunks of k codes for the max
// pass, then the same chunks of k codes and v for the p pass), so three
// chunks stay in flight across the switch between passes and between key
// blocks, with one __syncthreads a stage. A stage holds k rows of DP
// bytes (d padded to the 32-deep step: 16 -> 32, 40 -> 64, 80 -> 96) +
// 16 bytes against bank conflicts, then the v rows (d padded to 16: 40
// -> 48); keys >= Tk and the pads are zero-filled by the copy, which
// takes 8-byte cp.async where a head's code panel starts on 8 bytes only
// (d = 40). The int8 QK^T runs twice (the max pass and the
// p pass recompute the same integer logits, the cheaper product) on k
// fragments from ldmatrix.x4 (attn_mma.cuh:ring_logits_s8). The max pass
// keeps the integer max (and min) and scales it once a block: f32(s) * ls
// is monotone in s, so that is the max of the scaled logits, bit for bit.
//
// int8_flash: v is bf16 row-major in the stage and PV is the bf16 path's
// ring_pv (B fragments by ldmatrix.x4.trans; 16-key mma steps in
// ascending key order, as the previous kernel summed them).
//
// int8qkv_flash: PV on mma.sync m16n8k32 over round(127 p) in s8. The
// logits' f32 accumulator holds keys 2t, 2t+1 of each 8; an s8 A fragment
// wants k slots 4t..4t+3 of each 16, so each 32-key step is permuted
// (s8_slot; the s32 sum is unchanged) for p and v alike. sm_90a has no
// 8-bit ldmatrix.trans: the v codes stay row-major as copied, and one
// ldmatrix.x4.trans on b16 pairs of codes gives each lane keys 2t, 2t+1
// of 8m.. at columns 2g, 2g+1 of a 16-column group; __byte_perm splits
// them into the B fragments of two column tiles (the even columns, then
// the odd), so the mma's output column n of the pair is column 2n or
// 2n + 1 of the group, and a lane owns columns 4t..4t+3 of it. No
// transpose pass, no second buffer.
//
// round(127 p) takes its code from the bits of 127 p + 1.5 * 2^23
// (pack_s8), exactly rintf, off the conversion pipe that expf's ex2 and
// the logits' int -> float share. Every rounding step is the previous kernel's (expf, __fmul_rn,
// __fsub_rn; l summed per thread keys ascending, tile then register;
// rintf(__fmul_rn(p, 127)); the s32 PV of a key block added once in f32),
// so the outputs are its bits.
//
// Blocks and waves at B=1 T=4096, 10 heads (640 blocks of 4 warps):
// int8_flash is built for 5 blocks an SM (<= 96 registers a thread,
// spill-free), 660 slots on 132 SMs, one wave (B=2: 1280 blocks, 1.94
// waves); int8qkv_flash's s32 PV accumulators take 128 registers, 4
// blocks an SM, 528 slots, 1.21 waves (built for 5 it spilled 48 bytes
// and was no faster). d <= 32: 5 blocks; d = 40: 4 (int8_flash
// spilled 8 bytes built for 5); d = 80: 4 (int8_flash) / 3
// (int8qkv_flash); d = 128 and 160: 2. SD1.5 512
// (T=4096, 8 heads of 40: 512 blocks) runs them at its five 64x64 self
// sites under int8_flash "qk" / "qkv". 128-row blocks of 8
// warps sharing one ring (half the L2 reads) ran 20-28% slower at the
// main shape, and 6 stages no faster than 4 (PERF.md §6). f32 v
// under int8_flash (no step runs it at bf16) keeps the scalar path,
// flash_rows_f32.

#include <climits>
#include <type_traits>

#include "attn_mma.cuh"

using namespace mixdq;

namespace {

// the plan of ops/attention.py:int8_flash_plan
constexpr int I8_WARPS = 4;                 // a warp per 16 query rows
constexpr int I8_ROWS = 16 * I8_WARPS;      // query rows per block
constexpr int I8_THREADS = 32 * I8_WARPS;   // threads that fill the ring
constexpr int I8_STAGES = 4;                // ring stages: 3 chunks in flight
// the f32 scalar path: a warp per 16 of 64 rows
constexpr int F32_ROWS = 64, F32_THREADS = 128;

template <int D, bool V8>
struct I8Stage {
  // k row depth in codes: d padded to the m16n8k32 step (16 -> 32,
  // 40 -> 64, 80 -> 96); PV's depth: d padded to 16 (40 -> 48), the
  // column groups of ring_pv_s8 and of the bf16 ring_pv
  static constexpr int DP = (D + 31) / 32 * 32;
  static constexpr int DV = KvStage<D>::DP;
  static constexpr int LDK = DP + 16;         // k (and v code) row, bytes
  static constexpr int LDV = V8 ? LDK : KvStage<D>::LD * 2;  // v row
  static constexpr int V = KCH * LDK;         // bytes before the v rows
  static constexpr int BYTES = V + KCH * LDV;
  static constexpr int RING = I8_STAGES * BYTES;
  // blocks per SM the kernel is built for, as many as its registers
  // allow without spills (int8_flash at d = 40 spilled 8 bytes built for
  // 5)
  static constexpr int MIN_BLOCKS =
      D <= 32 ? 5 : D == 40 ? 4 : D == 64 ? (V8 ? 4 : 5)
      : D == 80 ? (V8 ? 3 : 4) : 2;
};

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

// Block-wide: keys [c0, c0 + KCH) of a panel (key j's ROW bytes at src +
// j * ld bytes) into the first PAD bytes of KCH shared rows of LD bytes
// at dst, by 16-byte copies, or 8-byte ones where ROW is no multiple of
// 16 (int8 codes at d = 40: a head's panel starts on 8 bytes only); keys
// >= Tk and the pad [ROW, PAD) zero-filled. The caller commits.
template <int ROW, int PAD, int LD>
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          size_t ld, int Tk, int c0) {
  constexpr int G = ROW % 16 ? 8 : 16, PER = PAD / G, N = KCH * PER;
  static_assert(ROW % G == 0 && PAD % G == 0, "whole copies a row");
#pragma unroll
  for (int it = 0; it < (N + I8_THREADS - 1) / I8_THREADS; ++it) {
    const int i = threadIdx.x + it * I8_THREADS;
    if (N % I8_THREADS == 0 || i < N) {
      const int key = i / PER, c = (i % PER) * G;
      const bool live = c0 + key < Tk, ok = live && (PAD == ROW || c < ROW);
      const char* s = src + (live ? c0 + key : 0) * ld + (ok ? c : 0);
      if constexpr (G == 16) cp_async16(dst + key * LD + c, s, ok);
      else cp_async8(dst + key * LD + c, s, ok);
    }
  }
}

// Block-wide: the cursor's chunk into the ring stage at shared address
// st: k codes, and with pass 1 the v rows (codes or bf16). Then one
// commit group (empty once the cursor is done).
template <int D, bool V8, typename TV>
__device__ __forceinline__ void issue_i8_chunk(uint32_t st, const int8_t* k,
                                               const TV* v, int ld, int ldv,
                                               int Tk,
                                               const ChunkCursor& cur) {
  using S = I8Stage<D, V8>;
  constexpr int TB = static_cast<int>(sizeof(TV));
  if (cur.j0 < Tk) {
    copy_rows<D, S::DP, S::LDK>(st, reinterpret_cast<const char*>(k), ld,
                                Tk, cur.c0);
    if (cur.pass)
      copy_rows<D * TB, S::DV * TB, S::LDV>(
          st + S::V, reinterpret_cast<const char*>(v), ldv * sizeof(TV), Tk,
          cur.c0);
  }
  cp_async_commit();
}

// The k index of local key q (0..31) in an s8 A fragment built from the
// logits' accumulator layout: tile nt = q / 8 holds keys 2t, 2t+1
// (mirror: ops/attention.py:s8_slot).
constexpr int s8_slot(int q) {
  return (q >> 4) * 16 + ((q & 7) >> 1) * 4 + ((q >> 3) & 1) * 2 + (q & 1);
}

// Byte i of register j of lane (g, t) names key a_key of p's A fragment
// (the pack order in int8_flash_ring) and key b_key of v's B fragment
// (ring_pv_s8: matrix 2j + i / 2, row 2t + i % 2); both sit at k slot
// 16 (j / 2) + 4t + i (A) and 16 j + 4t + i (B) of the m16n8k32 step.
constexpr int a_key(int t, int j, int i) {
  return (2 * (j >> 1) + (i >> 1)) * 8 + 2 * t + (i & 1);
}
constexpr int b_key(int t, int j, int i) {
  return 8 * (2 * j + (i >> 1)) + 2 * t + (i & 1);
}
constexpr bool slots_agree() {
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 4; ++i) {
      for (int j = 0; j < 4; ++j)
        if (s8_slot(a_key(t, j, i)) != 16 * (j >> 1) + 4 * t + i) return false;
      for (int j = 0; j < 2; ++j)
        if (s8_slot(b_key(t, j, i)) != 16 * j + 4 * t + i) return false;
    }
  return true;
}
static_assert(slots_agree(), "p and v fragments name other keys");

// pv += round(127 p) . v codes over one 32-key stage: pa the A fragments
// of p in s8_slot order, the v code rows (KCH rows of LDV bytes at shared
// address vr) by ldmatrix.x4.trans on b16 pairs: lane l addresses key l,
// and matrix m gives each lane keys 8m + 2t, 8m + 2t + 1 at columns 2g,
// 2g + 1 of the 16-column group. pv[2G] holds the group's even columns,
// pv[2G + 1] its odd ones.
template <int DV, int LDV>
__device__ __forceinline__ void ring_pv_s8(uint32_t vr, const int (&pa)[4],
                                           int (&pv)[DV / 8][4], int lane) {
  const uint32_t vb = vr + lane * LDV;
#pragma unroll
  for (int G = 0; G < DV / 16; ++G) {
    uint32_t r[4];
    ldsm_x4_trans(r, vb + G * 16);
    // k slots 4t..4t+3 = keys 2t, 2t+1, 8+2t, 9+2t (then + 16)
    const int be[2] = {static_cast<int>(__byte_perm(r[0], r[1], 0x6420)),
                       static_cast<int>(__byte_perm(r[2], r[3], 0x6420))};
    const int bo[2] = {static_cast<int>(__byte_perm(r[0], r[1], 0x7531)),
                       static_cast<int>(__byte_perm(r[2], r[3], 0x7531))};
    mma_s8(pv[2 * G], pa, be);
    mma_s8(pv[2 * G + 1], pa, bo);
  }
}

// 1.5 * 2^23: in [2^23, 2^24) a float's unit is 1, so x + ROUND_MAGIC
// for x in [0, 2^22) is ROUND_MAGIC + rintf(x) (to nearest, ties to
// even), with rintf(x) in the low bits. That spares the conversion pipe
// (a quarter of the ALU's rate), which expf's ex2 needs.
constexpr float ROUND_MAGIC = 12582912.f;

// The s8 codes of rintf(x) for x in [0, 127] (x = 127 p, p in [0, 1]),
// four a register, a in the lowest byte.
__device__ __forceinline__ int pack_s8(float a, float b, float c, float d) {
  const uint32_t lo = __byte_perm(__float_as_uint(__fadd_rn(a, ROUND_MAGIC)),
                                  __float_as_uint(__fadd_rn(b, ROUND_MAGIC)),
                                  0x40);
  const uint32_t hi = __byte_perm(__float_as_uint(__fadd_rn(c, ROUND_MAGIC)),
                                  __float_as_uint(__fadd_rn(d, ROUND_MAGIC)),
                                  0x40);
  return static_cast<int>(__byte_perm(lo, hi, 0x5410));
}

// One head over q/k codes for an I8_ROWS-row tile (nq valid rows) into
// out (the tile's first row, the head's first column; row stride ld),
// over key blocks of bk keys (a multiple of KCH); ring: the shared
// address of the I8_STAGES stages.
template <int D, bool V8, typename TV, typename TO>
__device__ void int8_flash_ring(uint32_t ring, const int8_t* q,
                                const int8_t* k, const TV* v, TO* out,
                                int ld, int ldv, int nq, int Tk, int bk,
                                float ls, float vs) {
  using S = I8Stage<D, V8>;
  constexpr int DP = S::DP, DV = S::DV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows

  ChunkCursor fill{0, 0, 0};
#pragma unroll
  for (int i = 0; i < I8_STAGES - 1; ++i) {
    issue_i8_chunk<D, V8, TV>(ring + i * S::BYTES, k, v, ld, ldv, Tk, fill);
    fill.next(Tk, bk);
  }
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

  // The next stage once its copies have landed; the stage consumed before
  // it (every warp is past it) is refilled from the cursor.
  int stage = 0;
  auto next_stage = [&]() {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    issue_i8_chunk<D, V8, TV>(
        ring + (stage == 0 ? I8_STAGES - 1 : stage - 1) * S::BYTES, k, v, ld,
        ldv, Tk, fill);
    fill.next(Tk, bk);
    const uint32_t st = ring + stage * S::BYTES;
    stage = stage + 1 == I8_STAGES ? 0 : stage + 1;
    return st;
  };

  int s32[KCH / 8][4];
  float p[KCH / 8][4];
  float o[DV / 8][4] = {};
  // running max of rows ra / rb (the same in the row's four threads) and
  // this thread's share of their running sums
  float ma = MASKED, mb = MASKED, la = 0.f, lb = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += bk) {
    const int jend = min(j0 + bk, Tk);
    // pass 1: the block's row max. f32(s) * ls is monotone in the integer
    // logit s, so the max of the scaled logits is the scaled max of the
    // integer ones (the min where ls < 0), bit for bit.
    int xa = INT_MIN, xb = INT_MIN, ya = INT_MAX, yb = INT_MAX;
    for (int c0 = j0; c0 < jend; c0 += KCH) {
      ring_logits_s8<DP, S::LDK>(next_stage(), qf, s32, lane);
      const int live = Tk - c0;  // keys of the stage below Tk
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (live < KCH && nt * 8 + 2 * t + (r & 1) >= live) continue;
          const int x = s32[nt][r];
          if (r < 2) {
            xa = max(xa, x);
            ya = min(ya, x);
          } else {
            xb = max(xb, x);
            yb = min(yb, x);
          }
        }
    }
    // MASKED where this thread saw no key of the block
    const float ca = xa == INT_MIN ? MASKED
                     : __fmul_rn(__int2float_rn(ls < 0.f ? ya : xa), ls);
    const float cb = xb == INT_MIN ? MASKED
                     : __fmul_rn(__int2float_rn(ls < 0.f ? yb : xb), ls);
    const float na = fmaxf(ma, quad_max(ca)), nb = fmaxf(mb, quad_max(cb));
    const float aa = expf(__fsub_rn(ma, na)), ab = expf(__fsub_rn(mb, nb));
    ma = na;
    mb = nb;
    la = __fmul_rn(la, aa);
    lb = __fmul_rn(lb, ab);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      o[dt][0] = __fmul_rn(o[dt][0], aa);
      o[dt][1] = __fmul_rn(o[dt][1], aa);
      o[dt][2] = __fmul_rn(o[dt][2], ab);
      o[dt][3] = __fmul_rn(o[dt][3], ab);
    }
    int pv[V8 ? DV / 8 : 1][4] = {};
    for (int c0 = j0; c0 < jend; c0 += KCH) {  // pass 2: p, l, p.v
      const uint32_t st = next_stage();
      ring_logits_s8<DP, S::LDK>(st, qf, s32, lane);
      const int live = Tk - c0;
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = 0.f;
          if (live >= KCH || nt * 8 + 2 * t + (r & 1) < live)
            x = expf(__fsub_rn(__fmul_rn(__int2float_rn(s32[nt][r]), ls),
                               r < 2 ? na : nb));
          p[nt][r] = x;
          if (r < 2) la += x;
          else lb += x;
        }
      if constexpr (V8) {  // round(127 p): rintf in pack_s8
        float c[KCH / 8][4];
#pragma unroll
        for (int i = 0; i < KCH / 8; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[i][r] = __fmul_rn(p[i][r], 127.f);
        const int pa[4] = {pack_s8(c[0][0], c[0][1], c[1][0], c[1][1]),
                           pack_s8(c[0][2], c[0][3], c[1][2], c[1][3]),
                           pack_s8(c[2][0], c[2][1], c[3][0], c[3][1]),
                           pack_s8(c[2][2], c[2][3], c[3][2], c[3][3])};
        ring_pv_s8<DV, S::LDV>(st + S::V, pa, pv, lane);
      } else {
        ring_pv<D>(st + S::V, p, o, lane);
      }
    }
    if constexpr (V8) {
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          o[dt][r] = __fadd_rn(o[dt][r],
                               __fmul_rn(__int2float_rn(pv[dt][r]), vs));
    }
  }
  cp_async_wait<0>();  // the empty groups past the last fill
  la = quad_sum(la);
  lb = quad_sum(lb);
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r < 2 ? ra : rb;
      // bf16 PV: tile dt, columns 2t, 2t+1; s8 PV: tile dt is the even
      // (dt even) or odd columns of group dt / 2 (ring_pv_s8); columns
      // >= D are the pad's
      const int col = V8 ? (dt >> 1) * 16 + 4 * t + 2 * (r & 1) + (dt & 1)
                         : dt * 8 + 2 * t + (r & 1);
      if (row >= nq || (DV > D && col >= D)) continue;
      store_f32(out + static_cast<size_t>(row) * ld + col,
                __fdiv_rn(o[dt][r], r < 2 ? la : lb));
    }
}

// Block tile (batch, head, I8_ROWS query rows) of the grid.
template <int D, bool V8, typename TO>
__device__ __forceinline__ void int8_flash_tile(const I8Args& a) {
  using TV = typename std::conditional<V8, int8_t, bf16>::type;
  extern __shared__ __align__(16) unsigned char i8_ring[];
  const int rt = (a.Tq + I8_ROWS - 1) / I8_ROWS, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const int ld = a.heads * D;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * I8_ROWS;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(I8_ROWS, a.Tq - r * I8_ROWS);
  int8_flash_ring<D, V8, TV, TO>(
      smem_addr(i8_ring), a.q + row0 * ld + h * D, a.k + key0 * ld + h * D,
      static_cast<const TV*>(a.v) + key0 * a.ldv + h * D,
      static_cast<TO*>(a.out) + row0 * ld + h * D, ld, a.ldv, nq, a.Tk, a.bk,
      *a.ls, V8 ? *a.vs : 0.f);
}

// int8_flash_attention: bf16 v, bf16 out.
template <int D>
__global__ void __launch_bounds__(I8_THREADS, (I8Stage<D, false>::MIN_BLOCKS))
    int8_flash_kernel(const I8Args a) {
  int8_flash_tile<D, false, bf16>(a);
}

// int8qkv_flash_attention: v codes, bf16 or f32 out.
template <int D, typename TO>
__global__ void __launch_bounds__(I8_THREADS, (I8Stage<D, true>::MIN_BLOCKS))
    int8qkv_flash_kernel(const I8Args a) {
  int8_flash_tile<D, true, TO>(a);
}

template <int D, bool V8, typename TO>
void (*ring_kernel())(I8Args) {
  if constexpr (V8) return int8qkv_flash_kernel<D, TO>;
  else return int8_flash_kernel<D>;
}

__device__ __forceinline__ int dot_s8(const int8_t* a, const int8_t* b,
                                      int n) {
  int s = 0;
  for (int i = 0; i < n; i += 4)
    s = __dp4a(*reinterpret_cast<const int*>(a + i),
               *reinterpret_cast<const int*>(b + i), s);
  return s;
}

// int8 QK^T, f32 v: the scalar path, a warp per 16 rows of a 64-row tile.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    int8_flash_f32_kernel(const I8Args a) {
  const int rt = (a.Tq + F32_ROWS - 1) / F32_ROWS, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const int ld = a.heads * D;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * F32_ROWS;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(F32_ROWS, a.Tq - r * F32_ROWS);
  const float ls = *a.ls;
  const int8_t* k = a.k + key0 * ld + h * D;
  const size_t w0 = row0 + (threadIdx.x >> 5) * 16;
  const int8_t* q = a.q + w0 * ld + h * D;
  flash_rows_f32<D>(
      [=](int i, int j) {
        return __fmul_rn(
            __int2float_rn(dot_s8(q + static_cast<size_t>(i) * ld,
                                  k + static_cast<size_t>(j) * ld, D)),
            ls);
      },
      static_cast<const float*>(a.v) + key0 * a.ldv + h * D,
      static_cast<float*>(a.out) + w0 * ld + h * D, a.ldv, ld,
      max(0, min(16, nq - static_cast<int>(threadIdx.x >> 5) * 16)), a.Tk,
      a.bk);
}

// The ring's dynamic shared memory (above 48 KB at d = 128, bf16 v) and
// the largest carveout, so that MIN_BLOCKS blocks fit on an SM; once per
// kernel.
template <int D, bool V8, typename TO>
cudaError_t ring_attrs() {
  cudaError_t e = cudaFuncSetAttribute(
      ring_kernel<D, V8, TO>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      I8Stage<D, V8>::RING);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(ring_kernel<D, V8, TO>(),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The plan of ops/attention.py:int8_flash_plan, as the wrapper passes it.
struct I8Plan {
  int rows, threads, stages, stage_keys, stage_bytes, ring_bytes,
      blocks_per_sm;
};

// The ring kernel at (D, V8, TO), or with F32V the scalar path (f32 v,
// no ring), under the plan that the wrapper passed.
template <int D, bool V8, typename TO, bool F32V>
int launch(const I8Args& a, const I8Plan& p, cudaStream_t stream) {
  using S = I8Stage<D, V8>;
  // the plan must be this build's block, ring and blocks an SM
  if (p.rows != I8_ROWS || p.threads != I8_THREADS ||
      p.stages != I8_STAGES || p.stage_keys != KCH ||
      p.stage_bytes != S::BYTES || p.ring_bytes != S::RING ||
      p.blocks_per_sm != S::MIN_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (F32V) {
    const int grid = a.B * a.heads * ((a.Tq + F32_ROWS - 1) / F32_ROWS);
    int8_flash_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(a);
  } else {
    static const cudaError_t attrs = ring_attrs<D, V8, TO>();
    if (attrs != cudaSuccess) return static_cast<int>(attrs);
    const int grid = a.B * a.heads * ((a.Tq + I8_ROWS - 1) / I8_ROWS);
    void (*kernel)(I8Args) = ring_kernel<D, V8, TO>();
    kernel<<<grid, I8_THREADS, S::RING, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool V8, typename TO, bool F32V>
int launch_d(const I8Args& a, int d, const I8Plan& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, V8, TO, F32V>(a, p, stream);
    case 32: return launch<32, V8, TO, F32V>(a, p, stream);
    case 40: return launch<40, V8, TO, F32V>(a, p, stream);
    case 64: return launch<64, V8, TO, F32V>(a, p, stream);
    case 80: return launch<80, V8, TO, F32V>(a, p, stream);
    case 128: return launch<128, V8, TO, F32V>(a, p, stream);
    case 160: return launch<160, V8, TO, F32V>(a, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Whether int8 code panels at head dim d can be copied: rows and base on
// 16 bytes, or on 8 where d is no multiple of 16 (copy_rows' 8-byte
// copies).
static bool codes_aligned(const void* p, int ld, int d) {
  const int g = d % 16 ? 8 : 16;
  return ld % g == 0 && reinterpret_cast<uintptr_t>(p) % g == 0;
}

// q / k codes [B*T, heads*d] (16-byte aligned, or 8-byte where d % 16 is
// 8); v: the bf16 or f32 panel
// (row stride ldv) or, with int8_v, codes [B*Tk, heads*d] (ldv =
// heads*d); out [B*Tq, heads*d] in bf16 (out_bf16) or f32; bk keys a
// block (a multiple of KCH); ls / vs device scalars; rows .. blocks_per_sm:
// the plan of ops/attention.py:int8_flash_plan(d, int8_v).
extern "C" int mixdq_int8_flash_attention(
    const int8_t* q, const int8_t* k, const void* v, void* out, int ldv,
    int B, int Tq, int Tk, int heads, int d, int bk, int int8_v, int v_bf16,
    int out_bf16, const float* ls, const float* vs, int rows, int threads,
    int stages, int stage_keys, int stage_bytes, int ring_bytes,
    int blocks_per_sm, cudaStream_t stream) {
  const I8Args a{q, k, v, out, ldv, B, Tq, Tk, heads, bk, ls, vs};
  const I8Plan p{rows,       threads,    stages,       stage_keys,
                 stage_bytes, ring_bytes, blocks_per_sm};
  const int ld = heads * d;
  if (bk <= 0 || bk % KCH || !codes_aligned(k, ld, d) ||
      reinterpret_cast<uintptr_t>(q) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int8_v) {
    if (!codes_aligned(v, ld, d) || ldv != ld || vs == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return out_bf16 ? launch_d<true, bf16, false>(a, d, p, stream)
                    : launch_d<true, float, false>(a, d, p, stream);
  }
  if (v_bf16 != out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (v_bf16 && !vec16(v, ldv * 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return v_bf16 ? launch_d<false, bf16, false>(a, d, p, stream)
                : launch_d<false, float, true>(a, d, p, stream);
}
