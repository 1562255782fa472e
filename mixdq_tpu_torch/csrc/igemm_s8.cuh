// Pipelined int8 GEMM mainloop with split-K in one launch, shared by the
// dense GEMM (qmatmul.cu), the implicit-GEMM convolution (qconv.cu), the
// fused act-quantize GEMMs (qmatmul_fused.cu), the GEMM stages of the
// cooperative sec_attention* kernels (sec_attention.cuh), the GEGLU
// projection and both GEMM stages of the whole feed-forward
// (geglu_qmatmul.cu).
//
// C [M, N] = A [M, Kdim] x B [Kdim, N] in int32, A int8 codes behind a
// loader (row-major codes: DenseA; the im2col view of an NHWC image:
// ConvA; bf16 activations quantized on their way in: QuantA), B the
// row-major int8 weight as deployed (HWIO for a conv is [kh kw C, K]).
// run_tile computes one output tile (a persistent grid walks several);
// run_block the tile at the block's place in the grid.
//
// Tiles. A block of 8 warps (2 x 4) owns a 128 x 128 output tile; each
// warp 64 rows x 32 columns (4 x 4 mma.sync m16n8k32 s8 tiles). Warps
// skip the 16-row m tiles that lie wholly past M (M = 1 multiplies one
// m16 tile per column slab, M = 77 five) and their whole 32-column slab
// when it lies past N. One block an SM (geglu_qmatmul: two, on a 2-stage
// ring): the plans (ops/qmatmul.py:qmm_plan) launch at most one wave
// where they split.
//
// Ring. A k step is 128 bytes of Kdim. The A tile (128 x 128) and the B
// tile (128 x 128) of a step land in one of STAGES ring stages in dynamic
// shared memory (4 x 32 KB) through cp.async.cg 16-byte copies, one
// commit group per stage: while step i is multiplied, steps i+1 ..
// i+STAGES-1 are in flight. One barrier a step. The copy modes are known
// at compile time on the fast path (A rows and B rows in 16-byte chunks);
// ragged widths take the run-time modes (4-byte or byte copies).
//
// Fragments. A stays [m][k] (rows of 128 bytes, 16-byte chunks
// XOR-swizzled by row % 8) and its fragments come from ldmatrix.x4. B
// stays [k][n] as cp.async lands it (rows of 128 bytes, chunks
// XOR-swizzled by 2 ((k / 4) % 4)). The mma's .col B register wants 4
// consecutive k of one column: a thread loads the 32-bit words of rows
// 4t..4t+3 at bytes 4g..4g+3 of its warp's slab and transposes the 4 x 4
// bytes in registers (8 prmt), which gives the B registers of four mma
// tiles at once, mma tile i reading physical column 4g + i as its column
// g. So the accumulators of thread (g, t) hold 8 consecutive physical
// columns 8t .. 8t+7 of its rows, and the epilogue stores them as one
// 16-byte (bf16) or two 16-byte (f32) vectors. Both fragment loads are
// free of bank conflicts under the swizzles.
//
// Split-K. Where the plan splits Kdim (whole k steps but the last), each
// block writes its int32 partial tile to a workspace, and the last block
// of a tile to arrive (a per-tile counter, reset to 0 by that block) sums
// the partials and runs the epilogue, in the same launch. Integer sums are
// exact in any order, so the output does not depend on the arrival order.
//
// What bounds it (H100 runs with parts of the loop turned off): with one
// 8-warp block an SM, the per-step instructions (fragment loads, byte
// transposes, copies, the barrier) leave mma.sync at a fraction of its
// rate; wgmma on a K-major weight (B [n][k] in shared memory, no
// transpose) is the next lever.
#pragma once

#include "cp_async.cuh"
#include "mma_s8.cuh"

namespace mixdq {
namespace igemm {

constexpr int BM = 128, BN = 128, BK = 128;  // block tile, k bytes a step
constexpr int NT = 256;                      // 8 warps: 2 (rows) x 4 (cols)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK, B_BYTES = BK * BN;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE;
constexpr int TILE_INTS = BM * BN;  // one split's partial tile
// A copies: thread t takes rows t / 4 and t / 4 + 64, 16-byte chunks
// t % 4 and t % 4 + 4 of each; B copies: chunks t + 256 j, j < 4
static_assert(BM == 2 * (NT / 4) && BK == 8 * 16, "A copy layout");
static_assert(B_BYTES == 4 * NT * 16, "B copy layout");

// Byte offsets in a stage: A row r (0..127), 16-byte chunk c (0..7),
// chunks XOR-swizzled by r % 8; B row k (0..127), chunk c (0..7), chunks
// XOR-swizzled by 2 ((k / 4) % 4).
__device__ __forceinline__ int a_off(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}
__device__ __forceinline__ int b_off(int k, int c) {
  return k * BN + ((c ^ (((k >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, int word) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
               "r"(word));
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const Chunk16& u) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(u.v.x), "r"(u.v.y), "r"(u.v.z), "r"(u.v.w));
}

__device__ __forceinline__ int splat(int code) {
  return static_cast<int>(static_cast<uint8_t>(code)) * 0x01010101;
}

// How the B rows are copied: 16-byte cp.async (N a multiple of 16 and w
// on 16 bytes), 4-byte cp.async (N a multiple of 4), or byte loads.
enum BMode { B_COPY16 = 0, B_COPY4 = 1, B_COPY1 = 2 };

struct BSrc {
  const int8_t* w;
  int N, mode;
};

// This thread's share of the B tile of the step at k0: rows k0 .. k0+127,
// columns n0 .. n0+127; rows at or past k_end and columns past N read 0.
// FAST: the 16-byte mode, known at compile time.
template <bool FAST>
__device__ __forceinline__ void issue_b(uint32_t bs, const BSrc& b, int k0,
                                        int k_end, int n0) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * NT;
    const int kl = i >> 3, c = i & 7;
    const int k = k0 + kl, n = n0 + c * 16;
    const uint32_t dst = bs + b_off(kl, c);
    const int8_t* src = b.w + static_cast<size_t>(k) * b.N + n;
    const bool krow = k < k_end;
    if (FAST || b.mode == B_COPY16) {
      const bool ok = krow && n < b.N;
      cp_async16(dst, ok ? src : b.w, ok);
    } else if (b.mode == B_COPY4) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const bool ok = krow && n + j < b.N;
        cp_async4(dst + j, ok ? src + j : b.w, ok);
      }
    } else {
      Chunk16 u = fill16(0);
      if (krow) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < b.N) u.s[j] = src[j];
      }
      st_shared16(dst, u);
    }
  }
}

// The GEGLU projection's weight [K, 2H] as deployed (value columns [0, H),
// gate columns [H, 2H)) as a B operand whose tile at output column n0
// holds 64 output columns: 16-byte chunk c of a row is value columns n0 +
// 16 (c / 2) .. +15 for even c and their gate columns for odd c, so every
// 32-column warp slab is 16 value columns and then the same 16 gate
// columns, and thread (g, t) of the slab holds value columns for t < 2 and
// the same columns' gates for t >= 2 (lanes t and t ^ 2). Columns at or
// past H read 0 in both halves. mode: b_mode(w, H), as both halves of a
// row start at a multiple of H.
struct GegluB {
  const int8_t* w;
  int H, mode;
};

template <bool FAST>
__device__ __forceinline__ void issue_b(uint32_t bs, const GegluB& b, int k0,
                                        int k_end, int n0) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * NT;
    const int kl = i >> 3, c = i & 7;
    const int k = k0 + kl, n = n0 + (c >> 1) * 16;
    const uint32_t dst = bs + b_off(kl, c);
    const int8_t* src =
        b.w + static_cast<size_t>(k) * 2 * b.H + (c & 1) * b.H + n;
    const bool krow = k < k_end;
    if (FAST || b.mode == B_COPY16) {
      const bool ok = krow && n < b.H;
      cp_async16(dst, ok ? src : b.w, ok);
    } else if (b.mode == B_COPY4) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const bool ok = krow && n + j < b.H;
        cp_async4(dst + j, ok ? src + j : b.w, ok);
      }
    } else {
      Chunk16 u = fill16(0);
      if (krow) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < b.H) u.s[j] = src[j];
      }
      st_shared16(dst, u);
    }
  }
}

// Row-major A codes [M, K]; `vec`: K a multiple of 16 and x on 16 bytes
// (FAST: known to hold).
template <bool FAST>
struct DenseA {
  const int8_t* x;
  int M, K;
  bool vec;
  const int8_t* row[2];  // this thread's two rows, null past M

  __device__ __forceinline__ void init(int m0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + (threadIdx.x >> 2) + j * (BM / 2);
      row[j] = m < M ? x + static_cast<size_t>(m) * K : nullptr;
    }
  }

  __device__ __forceinline__ void issue(uint32_t as, int k0,
                                        int k_end) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (threadIdx.x & 3) + 4 * h, k = k0 + c * 16;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t dst = as + a_off((threadIdx.x >> 2) + j * (BM / 2), c);
        if (FAST || vec) {
          const bool ok = row[j] != nullptr && k < k_end;
          cp_async16(dst, ok ? row[j] + k : x, ok);
        } else {
          Chunk16 u = fill16(0);
          if (row[j] != nullptr) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (k + i < k_end) u.s[i] = row[j][k + i];
          }
          st_shared16(dst, u);
        }
      }
    }
  }
};

// The im2col view of NHWC codes [B, H, W, C] under a kh x kw window of
// the given stride and padding: row m = output pixel (b, p, q), column
// k = (r kw + s) C + c. Out-of-image taps read the zero-point code zp.
// `vec` (FAST: known to hold): C a multiple of 16 and x on 16 bytes, so
// a 16-byte chunk is 16 channels of one tap.
template <bool FAST>
struct ConvA {
  const int8_t* x;
  int H, W, C, kw, zp;
  bool vec;
  const int8_t* img[2];  // this thread's rows: image base, null past M
  int ih0[2], iw0[2];
  // FAST: the tap (r, s) and channel c of this thread's two chunks of the
  // next step, kept across steps (a step moves k by BK)
  int tr[2], ts[2], tc[2];

  __device__ __forceinline__ void init(int m0, int M, int PQ, int Q,
                                       int stride, int ph, int pw,
                                       int k_begin) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + (threadIdx.x >> 2) + j * (BM / 2);
      const int b = m / PQ, pq = m - b * PQ, p = pq / Q, q = pq - p * Q;
      img[j] = m < M ? x + static_cast<size_t>(b) * H * W * C : nullptr;
      ih0[j] = p * stride - ph;
      iw0[j] = q * stride - pw;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k_begin + ((threadIdx.x & 3) + 4 * h) * 16;
      const int tap = k / C;
      tc[h] = k - tap * C;
      tr[h] = tap / kw;
      ts[h] = tap - tr[h] * kw;
    }
  }

  __device__ __forceinline__ int8_t tap_byte(int j, int k) const {
    const int tap = k / C, c = k - tap * C;
    const int r = tap / kw, s = tap - r * kw;
    const int ih = ih0[j] + r, iw = iw0[j] + s;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W)
      return static_cast<int8_t>(zp);
    return img[j][(static_cast<size_t>(ih) * W + iw) * C + c];
  }

  // the next step's chunks, at k0 (every step in order)
  __device__ __forceinline__ void issue(uint32_t as, int k0, int k_end) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = (threadIdx.x & 3) + 4 * h, k = k0 + cc * 16;
      if (FAST || vec) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t dst =
              as + a_off((threadIdx.x >> 2) + j * (BM / 2), cc);
          const int ih = ih0[j] + tr[h], iw = iw0[j] + ts[h];
          if (img[j] == nullptr || k >= k_end) {
            cp_async16(dst, x, false);
          } else if (ih < 0 || ih >= H || iw < 0 || iw >= W) {
            st_shared16(dst, splat(zp));
          } else {
            cp_async16(
                dst, img[j] + (static_cast<size_t>(ih) * W + iw) * C + tc[h],
                true);
          }
        }
        tc[h] += BK;  // the same chunk of the next step
        while (tc[h] >= C) {
          tc[h] -= C;
          if (++ts[h] == kw) {
            ts[h] = 0;
            ++tr[h];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Chunk16 u = fill16(0);
          if (img[j] != nullptr) {
#pragma unroll 4
            for (int i = 0; i < 16; ++i)
              if (k + i < k_end) u.s[i] = tap_byte(j, k + i);
          }
          st_shared16(as + a_off((threadIdx.x >> 2) + j * (BM / 2), cc), u);
        }
      }
    }
  }
};

// 1.5 * 2^23: for |t| <= 2^22, fl(t + QMAGIC) = QMAGIC + rint(t) (ties to
// even, as rintf), exact, the integer in the low mantissa bits.
constexpr float QMAGIC = 12582912.f;

// The per-tensor act quantizer's codes of 8 bf16 values (one 16-byte
// load; the bf16 -> f32 widening is exact), quant_code's result bit for
// bit. zint (zp integer-valued, |zp| <= 2^21): in QMAGIC's range,
// u = clip(fl(fl(t + QMAGIC) + zp), QMAGIC - 128, QMAGIC + 127), t =
// fl(y sinv), holds QMAGIC + the code exactly, its low byte the code; past
// |t| = 2^22 u lies beyond the same clip bound as quant_code's value, and
// NaN clips low in both. Five f32 instructions an element against
// quant_code's rint and int conversions, which run at a fraction of the
// f32 rate. Any other zp takes quant_code.
__device__ __forceinline__ uint2 quant8_bf16(const uint4& v, float sinv,
                                             float zp, bool zint) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = w[2 * h + j / 2];
      const float y = __uint_as_float(j % 2 ? u & 0xffff0000u : u << 16);
      if (zint) {
        float m = __fadd_rn(__fadd_rn(__fmul_rn(y, sinv), QMAGIC), zp);
        m = fminf(fmaxf(m, QMAGIC - 128.f), QMAGIC + 127.f);
        q[j] = __float_as_uint(m);
      } else {
        q[j] = static_cast<uint32_t>(quant_code(y, sinv, zp, -128.f, 127.f));
      }
    }
    c[h] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                       __byte_perm(q[2], q[3], 0x0040), 0x5410);
  }
  return make_uint2(c[0], c[1]);
}

// zp qualifies for quant8_bf16's f32 path.
inline bool zp_integral(float zp) {
  return zp == rintf(zp) && fabsf(zp) <= 2097152.f;
}

// 8 bf16 values at src of which the first n are in range (zeros past
// them): one 16-byte load when vec and n >= 8.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src, int n,
                                            bool vec) {
  if (vec) return n >= 8 ? __ldg(reinterpret_cast<const uint4*>(src))
                         : make_uint4(0u, 0u, 0u, 0u);
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    e[j] = j < n ? reinterpret_cast<const uint16_t*>(src)[j] : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

// The quantizing ring (qmatmul_fused): QSTAGES stages of the bf16 x tile
// of a step (128 rows x 128 k, 32 KB) and its B tile, and two A stages of
// codes (16 KB each) that the products read.
constexpr int X_BYTES = 2 * BM * BK;
constexpr int QSTAGE = X_BYTES + B_BYTES;
constexpr int QSTAGES = 4;
constexpr int QSMEM = QSTAGES * QSTAGE + 2 * A_BYTES;
static_assert(QSMEM <= 232448, "quantizing ring exceeds a block's 227 KB");

// Byte offset of 16-byte chunk c (0..15, 8 bf16) of row r in an x stage:
// rows of 256 bytes, chunks XOR-swizzled by r % 2, so the quarter-warp of
// quantize_stage's 16-byte loads (2 rows, 4 chunks apart) hits 32 banks.
__device__ __forceinline__ int x_off(int r, int c) {
  return r * 2 * BK + ((c ^ (r & 1)) << 4);
}

// Raw bf16 activations x [M, K] (rows of stride ldx) as the A operand
// (qmatmul_fused). issue() copies the step's x tile into an x stage
// (cp.async 16-byte copies when `vec`, FAST: known to hold, which needs
// ldx and K multiples of 8 and x on 16 bytes; byte-exact loads and 16-byte
// shared stores otherwise); quantize_stage() turns a landed x stage into
// an A stage of codes, this thread's share being DenseA's (rows t / 4 and
// t / 4 + 64, 16-code chunks t % 4 and t % 4 + 4). Values at or past
// k_end and rows past M read 0: their codes meet zero weight rows or rows
// that are not stored.
template <bool FAST>
struct QuantA {
  const __nv_bfloat16* x;
  int M, ldx;
  float sinv, zp;
  bool zint;  // zp_integral(zp)
  bool vec;
  int m0;

  __device__ __forceinline__ void init(int m0_) { m0 = m0_; }

  // 128 rows x 16 chunks: thread t takes chunk t % 16 of rows t / 16 +
  // 16 i, i < 8
  __device__ __forceinline__ void issue(uint32_t xs, int k0,
                                        int k_end) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (threadIdx.x >> 4) + 16 * i, c = threadIdx.x & 15;
      const int m = m0 + r, k = k0 + 8 * c;
      const __nv_bfloat16* src = x + static_cast<size_t>(m) * ldx + k;
      if (FAST || vec) {
        const bool ok = m < M && k < k_end;
        cp_async16(xs + x_off(r, c), ok ? src : x, ok);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M) v = load8_bf16(src, k_end - k, false);
        Chunk16 u;
        u.v = make_int4(static_cast<int>(v.x), static_cast<int>(v.y),
                        static_cast<int>(v.z), static_cast<int>(v.w));
        st_shared16(xs + x_off(r, c), u);
      }
    }
  }

  // x stage (generic pointer) -> A stage of codes at shared address `as`
  __device__ __forceinline__ void quantize_stage(const unsigned char* xs,
                                                 uint32_t as) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (threadIdx.x >> 2) + j * (BM / 2);
        const int c = (threadIdx.x & 3) + 4 * h;
        const uint2 lo = quant8_bf16(
            *reinterpret_cast<const uint4*>(xs + x_off(r, 2 * c)), sinv, zp,
            zint);
        const uint2 hi = quant8_bf16(
            *reinterpret_cast<const uint4*>(xs + x_off(r, 2 * c + 1)), sinv,
            zp, zint);
        Chunk16 u;
        u.v = make_int4(static_cast<int>(lo.x), static_cast<int>(lo.y),
                        static_cast<int>(hi.x), static_cast<int>(hi.y));
        st_shared16(as + a_off(r, c), u);
      }
  }
};

template <class ALoad>
struct IsQuantA {
  static constexpr bool value = false;
};
template <bool FAST>
struct IsQuantA<QuantA<FAST>> {
  static constexpr bool value = true;
};

// 4 x 4 byte transpose: in w[r] byte i = (row r, col i); out[i] byte r.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_i8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one 32-k substep of a warp's 64 x 32 tile: A of its 4
// m tiles, B of its 4 mma column tiles (b[0]: k 0..15, b[1]: k 16..31).
struct Frags {
  uint32_t a[4][4];
  uint32_t b[2][4];
};

// Fragments of substep kk (0, 32, 64, 96) of the stage at `stage`
// (generic pointer) / `as` (its shared address); m tiles mi >= mtiles are
// not loaded.
__device__ __forceinline__ void load_frags(Frags& f, uint32_t as,
                                           const unsigned char* stage,
                                           int kk, int wm, uint32_t bcol,
                                           int mtiles) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const unsigned char* bs = stage + A_BYTES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(
          bs + (kk + 16 * h + 4 * t + r) * BN + bcol);
    transpose4x4(w, f.b[h]);
  }
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = kk / 16 + (lane >> 4);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    if (mi < mtiles)
      ldsm_x4(f.a[mi], as + a_off(wm + mi * 16 + arow, achunk));
}

__device__ __forceinline__ void mma_frags(const Frags& f, int mtiles,
                                          int (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    if (mi < mtiles)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_i8(acc[mi][i], f.a[mi], f.b[0][i], f.b[1][i]);
}

// The block's tile over Kdim range [k_begin, k_end) into acc. Every
// thread of the block calls it (it synchronizes the block). The A loader
// is called for the steps in order; B is a BSrc or a GegluB. NST: the
// ring's stages (NST * STAGE bytes of smem).
template <bool FAST, int NST = STAGES, class ALoad, class BLoad>
__device__ __forceinline__ void mainloop(ALoad& a, const BLoad& b,
                                         int n0, int k_begin, int k_end,
                                         unsigned char* smem, int wm,
                                         int wn, int mtiles, bool nlive,
                                         int (&acc)[4][4][4]) {
  const uint32_t base = smem_addr(smem);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool live = nlive && mtiles > 0;
  // this thread's byte in a B row: word g % 4 of chunk wn / 16 + g / 4,
  // the chunk swizzled by 2 ((k / 4) % 4) = 2t for every row it reads
  const uint32_t bcol =
      ((((wn >> 4) + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  auto issue = [&](int step) {
    const uint32_t st = base + (step % NST) * STAGE;
    a.issue(st, k_begin + step * BK, k_end);
    issue_b<FAST>(st + A_BYTES, b, k_begin + step * BK, k_end, n0);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  Frags f;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<NST - 2>();
    // step i landed, and every warp is done with step i - 1's stage
    __syncthreads();
    if (i + NST - 1 < steps) issue(i + NST - 1);
    cp_async_commit();
    const int slot = i % NST;
    if (!live) continue;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      load_frags(f, base + slot * STAGE, smem + slot * STAGE, 32 * s, wm,
                 bcol, mtiles);
      mma_frags(f, mtiles, acc);
    }
  }
  cp_async_wait<0>();
}

// mainloop's work over the quantizing ring (QuantA): step i's x and B
// tiles land in x stage i % QSTAGES; step i is multiplied from code stage
// i % 2, then step i + 1's landed x tile is quantized into code stage
// (i + 1) % 2 (after the products: 2-3% faster than before them on an
// H100); copies run up to three steps ahead. One barrier a step: it
// publishes step i's codes and frees step i - 1's stages.
template <bool FAST>
__device__ __forceinline__ void mainloop_quant(const QuantA<FAST>& a,
                                               const BSrc& b, int n0,
                                               int k_begin, int k_end,
                                               unsigned char* smem, int wm,
                                               int wn, int mtiles,
                                               bool nlive,
                                               int (&acc)[4][4][4]) {
  const uint32_t base = smem_addr(smem);
  const uint32_t codes = base + QSTAGES * QSTAGE;
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool live = nlive && mtiles > 0;
  const uint32_t bcol =
      ((((wn >> 4) + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  auto issue = [&](int step) {
    const uint32_t st = base + (step % QSTAGES) * QSTAGE;
    a.issue(st, k_begin + step * BK, k_end);
    issue_b<FAST>(st + X_BYTES, b, k_begin + step * BK, k_end, n0);
  };
  auto quantize = [&](int step) {
    a.quantize_stage(smem + (step % QSTAGES) * QSTAGE,
                     codes + (step & 1) * A_BYTES);
  };
#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<QSTAGES - 2>();  // step 0 landed
  __syncthreads();
  if (steps > 0) quantize(0);
  Frags f;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<QSTAGES - 3>();
    // step i + 1 landed, step i's codes are written, and every warp is
    // done with step i - 1's stages
    __syncthreads();
    if (i + QSTAGES - 1 < steps) issue(i + QSTAGES - 1);
    cp_async_commit();
    if (live) {
      // load_frags reads B at stage + A_BYTES
      const unsigned char* bstage =
          smem + (i % QSTAGES) * QSTAGE + X_BYTES - A_BYTES;
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
        load_frags(f, codes + (i & 1) * A_BYTES, bstage, 32 * s, wm, bcol,
                   mtiles);
        mma_frags(f, mtiles, acc);
      }
    }
    if (i + 1 < steps) quantize(i + 1);
  }
  cp_async_wait<0>();
}

// Split-K: this block's partial tile to the workspace, then the last
// block of the tile to arrive sums every split's partials into acc.
// Returns false in the blocks that are not last (they are done).
__device__ __forceinline__ bool reduce_splits(int* __restrict__ ws,
                                              unsigned* __restrict__ counters,
                                              int tile, int split,
                                              int splits, int mtiles,
                                              bool nlive,
                                              int (&acc)[4][4][4]) {
  __shared__ int s_last;
  const int tid = threadIdx.x;
  // fragment order: int4 r of thread tid at (r * NT + tid); the last
  // block's threads read the same places of the other splits
  auto part = [&](int s) {
    return reinterpret_cast<int4*>(ws) +
           (static_cast<size_t>(tile) * splits + s) * (TILE_INTS / 4);
  };
  if (nlive) {
    int4* mine = part(split);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      if (mi < mtiles)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mine[(mi * 4 + i) * NT + tid] =
              make_int4(acc[mi][i][0], acc[mi][i][1], acc[mi][i][2],
                        acc[mi][i][3]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned prev = atomicAdd(counters + tile, 1u);
    s_last = prev == static_cast<unsigned>(splits - 1);
    if (s_last) counters[tile] = 0;  // every split has arrived
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  if (nlive) {
    // the other splits' partials added to this block's own, a few
    // splits' loads in flight
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      if (s == split) continue;
      const int4* p = part(s);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        if (mi < mtiles)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int4 v = __ldcg(p + (mi * 4 + i) * NT + tid);
            acc[mi][i][0] += v.x;
            acc[mi][i][1] += v.y;
            acc[mi][i][2] += v.z;
            acc[mi][i][3] += v.w;
          }
    }
  }
  return true;
}

// A per-column or per-row vector read in its stored type (f32 or bf16;
// the bf16 -> f32 conversion is exact).
__device__ __forceinline__ float ldf(const void* p, bool bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

struct EpiArgs {
  const float* scale;
  const float* bias0;
  const void* bias;   // [N] f32 or bf16, or null
  const void* ebias;  // [B, N] f32 or bf16 (row m reads batch m / PQ), or null
  const void* res;    // [M, N] of the output type, or null
  void* out;          // [M, N]
  int M, N, PQ;
  bool bias_bf16, ebias_bf16, res_vec;
};

// 8 consecutive values of T as stored (16 or 32 bytes).
template <typename T>
struct alignas(16) Raw8 {
  uint4 w[sizeof(T) / 2];
};

__device__ __forceinline__ void unpack8(const Raw8<float>& u, float (&v)[8]) {
  const uint32_t w[8] = {u.w[0].x, u.w[0].y, u.w[0].z, u.w[0].w,
                         u.w[1].x, u.w[1].y, u.w[1].z, u.w[1].w};
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(w[j]);
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& u,
                                        float (&v)[8]) {
  const uint32_t w[4] = {u.w[0].x, u.w[0].y, u.w[0].z, u.w[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    v[2 * j] = __low2float(h);
    v[2 * j + 1] = __high2float(h);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The rows of the common case of `epilogue` (8 columns a thread in 16-
// or 32-byte vectors, no ebias, a 16-byte aligned residual or none): each
// element's steps as there, with bias (BIAS) and residual (RES) known at
// compile time, so that the per-element work has no branch; every
// residual row loaded before the first store (which may alias it for all
// the compiler knows), so that their round trips overlap.
template <typename T, bool INT_BIAS0, bool BIAS, bool RES>
__device__ __forceinline__ void epilogue_vec(const EpiArgs& e, int m0, int nb,
                                             int wm, int mtiles,
                                             const int (&acc)[4][4][4],
                                             const float (&sc)[8],
                                             const float (&b0)[8],
                                             const float (&bi)[8]) {
  const int g = (threadIdx.x & 31) >> 2;
  T* out = static_cast<T*>(e.out);
  Raw8<T> rraw[4][2];
  if constexpr (RES) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (mi < mtiles && m < e.M)
          rraw[mi][h] = *reinterpret_cast<const Raw8<T>*>(
              static_cast<const T*>(e.res) + static_cast<size_t>(m) * e.N +
              nb);
      }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi >= mtiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= e.M) continue;
      float y[8], r[8];
      if constexpr (RES) unpack8(rraw[mi][h], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = j < 4 ? acc[mi][j][2 * h] : acc[mi][j - 4][2 * h + 1];
        if constexpr (INT_BIAS0) {
          y[j] = __fmul_rn(__int2float_rn(v - __float2int_rz(b0[j])), sc[j]);
        } else {
          float yy = __fmul_rn(__fsub_rn(__int2float_rn(v), b0[j]), sc[j]);
          if constexpr (BIAS) yy = __fadd_rn(yy, bi[j]);
          if constexpr (RES) yy = __fadd_rn(yy, r[j]);
          y[j] = yy;
        }
      }
      store8(out + static_cast<size_t>(m) * e.N + nb, y);
    }
  }
}

// out = T(((f32(acc) - bias0) * scale + bias + ebias[b]) + res), each
// step rounded as the plain version rounds it; INT_BIAS0 (the fused
// act-quantize GEMMs, which take no bias, ebias or res): out = T(f32(acc
// - int32(bias0)) * scale), bias0 truncated and subtracted in int32.
// Thread (g, t) of the warp at (wm, wn) holds rows wm + 16 mi + g (+8)
// and columns wn + 8t .. +8: column j < 4 in acc[mi][j][0 / 2], j >= 4
// in acc[mi][j - 4][1 / 3].
template <typename T, bool INT_BIAS0 = false>
__device__ __forceinline__ void epilogue(const EpiArgs& e, int m0, int n0,
                                         int wm, int wn, int mtiles,
                                         const int (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nb = n0 + wn + 8 * t;
  if (nb >= e.N) return;
  const int ncols = min(8, e.N - nb);
  // bf16: 16 bytes a row need N % 8; f32: two 16-byte halves need N % 4
  const bool vec = ncols == 8 && e.N % (sizeof(T) == 2 ? 8 : 4) == 0;
  float sc[8], b0[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = j < ncols ? nb + j : nb;
    sc[j] = e.scale[n];
    b0[j] = e.bias0[n];
    bi[j] = e.bias ? ldf(e.bias, e.bias_bf16, n) : 0.f;
  }
  T* out = static_cast<T*>(e.out);
  const T* res = static_cast<const T*>(e.res);
  if (vec && !e.ebias && (!res || e.res_vec)) {
    if constexpr (INT_BIAS0) {
      epilogue_vec<T, true, false, false>(e, m0, nb, wm, mtiles, acc, sc, b0,
                                          bi);
    } else if (e.bias) {
      if (res)
        epilogue_vec<T, false, true, true>(e, m0, nb, wm, mtiles, acc, sc,
                                           b0, bi);
      else
        epilogue_vec<T, false, true, false>(e, m0, nb, wm, mtiles, acc, sc,
                                            b0, bi);
    } else {
      if (res)
        epilogue_vec<T, false, false, true>(e, m0, nb, wm, mtiles, acc, sc,
                                            b0, bi);
      else
        epilogue_vec<T, false, false, false>(e, m0, nb, wm, mtiles, acc, sc,
                                             b0, bi);
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi >= mtiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= e.M) continue;
      const size_t o = static_cast<size_t>(m) * e.N + nb;
      float y[8], r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = res && j < ncols ? to_f32(res[o + j]) : 0.f;
      const size_t eb = e.ebias ? static_cast<size_t>(m / e.PQ) * e.N : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = j < 4 ? acc[mi][j][2 * h] : acc[mi][j - 4][2 * h + 1];
        if constexpr (INT_BIAS0) {
          y[j] = __fmul_rn(__int2float_rn(v - __float2int_rz(b0[j])), sc[j]);
          continue;
        }
        float yy = __fmul_rn(__fsub_rn(__int2float_rn(v), b0[j]), sc[j]);
        if (e.bias) yy = __fadd_rn(yy, bi[j]);
        if (e.ebias && j < ncols)
          yy = __fadd_rn(yy, ldf(e.ebias, e.ebias_bf16, eb + nb + j));
        if (res) yy = __fadd_rn(yy, r[j]);
        y[j] = yy;
      }
      if (vec) {
        store8(out + o, y);
      } else {
        for (int j = 0; j < ncols; ++j) store_f32(out + o + j, y[j]);
      }
    }
  }
}

// One output tile (rows m0.., columns n0..; `tile` its split-K counter)
// over split `split` of `splits`: mainloop over this split's k range,
// split-K reduction, epilogue. Every thread of the block calls it.
template <typename T, bool FAST, bool INT_BIAS0, class ALoad>
__device__ __forceinline__ void run_tile(ALoad& a, const BSrc& b,
                                         const EpiArgs& e, int Kdim, int m0,
                                         int n0, int tile, int split,
                                         int splits, int split_k, int* ws,
                                         unsigned* counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int k_begin = split * split_k;
  const int k_end = min(Kdim, k_begin + split_k);
  const int mtiles = max(0, min(4, (e.M - m0 - wm + 15) / 16));
  const bool nlive = n0 + wn < e.N;
  int acc[4][4][4] = {};
  if constexpr (IsQuantA<ALoad>::value)
    mainloop_quant<FAST>(a, b, n0, k_begin, k_end, smem, wm, wn, mtiles,
                         nlive, acc);
  else
    mainloop<FAST>(a, b, n0, k_begin, k_end, smem, wm, wn, mtiles, nlive,
                   acc);
  if (splits > 1 &&
      !reduce_splits(ws, counters, tile, split, splits, mtiles, nlive, acc))
    return;
  if (nlive) epilogue<T, INT_BIAS0>(e, m0, n0, wm, wn, mtiles, acc);
}

// The whole block: run_tile at the block's place. Grid: x = column tiles,
// y = row tiles, z = splits.
template <typename T, bool FAST, bool INT_BIAS0 = false, class ALoad>
__device__ __forceinline__ void run_block(ALoad& a, const BSrc& b,
                                          const EpiArgs& e, int Kdim,
                                          int split_k, int* ws,
                                          unsigned* counters) {
  run_tile<T, FAST, INT_BIAS0>(a, b, e, Kdim, blockIdx.y * BM,
                               blockIdx.x * BN,
                               blockIdx.y * gridDim.x + blockIdx.x,
                               blockIdx.z, gridDim.z, split_k, ws, counters);
}

// The plan passed from Python (ops/qmatmul.py:qmm_plan) must be this
// build's: its tile and ring depth (`ring`: the kernel's), whole k steps
// per split but the last, the splits covering Kdim once, a workspace and
// counters when split.
inline bool plan_ok(int bm, int stages, int splits, int split_k, int Kdim,
                    const int* ws, const unsigned* counters,
                    int ring = STAGES) {
  if (bm != BM || stages != ring) return false;
  if (splits < 1 || split_k <= 0 || split_k % BK) return false;
  if (static_cast<long long>(splits) * split_k < Kdim ||
      static_cast<long long>(splits - 1) * split_k >= (Kdim > 0 ? Kdim : 1))
    return false;
  return splits == 1 || (ws != nullptr && counters != nullptr);
}

inline int b_mode(const int8_t* w, int N) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w);
  return vec16(w, N) ? B_COPY16 : (N % 4 == 0 && a % 4 == 0) ? B_COPY4
                                                             : B_COPY1;
}

// The ring's dynamic shared memory (SMEM, or QSMEM for the quantizing
// ring) and the largest carveout, once per kernel.
template <typename Kern>
cudaError_t set_smem(Kern kernel, int bytes = SMEM) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace igemm
}  // namespace mixdq
