// Tiled int8 GEMM building blocks shared by the conv, GEGLU, dense and
// attention kernels: a 64x64 output tile per 128-thread block (2x2 warps
// of 32x32), K in steps of 32, int32 accumulation with mma.sync m16n8k32
// (s8 x s8 -> s32).
//
// Shared-memory tiles hold both operands K-contiguous ([row][k] for A,
// [col][k] for B), as the mma fragments want 4 consecutive k values per
// 32-bit register. Rows are padded from 32 to 48 bytes so the fragment
// loads of one warp hit 32 distinct banks. Tiles move through registers
// (16 bytes per thread per operand): the next tile's global loads are
// issued before the current tile's mma, so their latency overlaps.
#pragma once

#include <atomic>

#include "common.cuh"

namespace mixdq {

constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 16, THREADS = 128;

union Chunk16 {
  int4 v;
  int8_t s[16];
};

__device__ __forceinline__ Chunk16 fill16(int8_t b) {
  const int w = static_cast<int>(static_cast<uint8_t>(b)) * 0x01010101;
  Chunk16 u;
  u.v = make_int4(w, w, w, w);
  return u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's 16-byte share of a B tile (32 k x 64 n): k row `tid / 4`,
// columns `(tid % 4) * 16 ..+16` of a row-major [Kdim, ldw] weight, read
// at physical column `coloff + n`; columns n >= ncols and rows k >= Kdim
// read as 0. `vec`: ldw, coloff and ncols are multiples of 16.
__device__ __forceinline__ Chunk16 load_b(const int8_t* __restrict__ w,
                                          int ldw, int coloff, int ncols,
                                          int Kdim, int k0, int n0, int tid,
                                          bool vec) {
  const int k = k0 + tid / 4;
  const int n = n0 + (tid % 4) * 16;
  Chunk16 u = fill16(0);
  if (k >= Kdim) return u;
  const int8_t* src = w + static_cast<size_t>(k) * ldw + coloff + n;
  if (vec) {
    if (n < ncols) u.v = *reinterpret_cast<const int4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (n + i < ncols) u.s[i] = src[i];
  }
  return u;
}

__device__ __forceinline__ void store_b(int8_t (*Bs)[LDS], const Chunk16& u,
                                        int tid) {
  const int k = tid / 4, nc = (tid % 4) * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) Bs[nc + i][k] = u.s[i];
}

// One thread's 16-byte share of an A tile (32 k per row) of row-major
// codes [M, K]: row `m0 + tid / 2`, k bytes `k0 + (tid % 2) * 16 ..+16`;
// rows m >= M and k >= K read as 0. `vec`: K and the base address are
// multiples of 16.
__device__ __forceinline__ Chunk16 load_a(const int8_t* __restrict__ x,
                                          int M, int K, int m0, int k0,
                                          int tid, bool vec) {
  const int m = m0 + tid / 2, k = k0 + (tid % 2) * 16;
  Chunk16 u = fill16(0);
  if (m >= M) return u;
  const int8_t* src = x + static_cast<size_t>(m) * K + k;
  if (vec) {
    if (k < K) u.v = *reinterpret_cast<const int4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < K) u.s[i] = src[i];
  }
  return u;
}

// A tile share: row `tid / 2`, k bytes `(tid % 2) * 16 ..+16`.
__device__ __forceinline__ void store_a(int8_t (*As)[LDS], const Chunk16& u,
                                        int tid) {
  *reinterpret_cast<int4*>(&As[tid / 2][(tid % 2) * 16]) = u.v;
}

// acc[mi][ni] is the m16n8 accumulator of rows wm + 16 mi, cols wn + 8 ni.
__device__ __forceinline__ void warp_mma(const int8_t (*As)[LDS],
                                         const int8_t (*Bs)[LDS], int wm,
                                         int wn, int lane,
                                         int (&acc)[2][4][4]) {
  const int g = lane >> 2, t = lane & 3;
  int a[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int8_t* r0 = As[wm + mi * 16 + g];
    const int8_t* r1 = As[wm + mi * 16 + g + 8];
    a[mi][0] = *reinterpret_cast<const int*>(r0 + t * 4);
    a[mi][1] = *reinterpret_cast<const int*>(r1 + t * 4);
    a[mi][2] = *reinterpret_cast<const int*>(r0 + 16 + t * 4);
    a[mi][3] = *reinterpret_cast<const int*>(r1 + 16 + t * 4);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int8_t* c0 = Bs[wn + ni * 8 + g];
    int b[2];
    b[0] = *reinterpret_cast<const int*>(c0 + t * 4);
    b[1] = *reinterpret_cast<const int*>(c0 + 16 + t * 4);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b);
  }
}

// Visit every accumulator element of this thread with its tile-relative
// (row, col): f(row, col, acc0 value, acc1 value) for two accumulators of
// the same layout (pass the same one twice where there is one).
template <typename Fn>
__device__ __forceinline__ void for_each_acc(int wm, int wn, int lane,
                                             const int (&acc0)[2][4][4],
                                             const int (&acc1)[2][4][4],
                                             Fn f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(wm + mi * 16 + g + (r >> 1) * 8, wn + ni * 8 + t * 2 + (r & 1),
          acc0[mi][ni][r], acc1[mi][ni][r]);
}

// One 64x64 output tile of A [M, K] x W [K, N] (row-major W codes): rows
// [m0, m0 + 64), columns [n0, n0 + 64), with this thread's share of each
// A tile from a_share(k0) (load_a's share of the 32 k from k0, as s8
// codes). Calls epi(m, n, acc) for every element of the tile, in or out
// of range (the caller masks). Every thread of the 128-thread block calls
// it: it synchronizes the block, and As/Bs are free again when it
// returns.
template <typename AShare, typename Epi>
__device__ __forceinline__ void gemm_tile_a(
    AShare a_share, int K, int m0, const int8_t* __restrict__ W, int N,
    int n0, bool bvec, int8_t (*As)[LDS], int8_t (*Bs)[LDS], Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4] = {};
  Chunk16 ra = a_share(0);
  Chunk16 rb = load_b(W, N, 0, N, K, 0, n0, tid, bvec);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_a(As, ra, tid);
    store_b(Bs, rb, tid);
    __syncthreads();
    if (k0 + BK < K) {
      ra = a_share(k0 + BK);
      rb = load_b(W, N, 0, N, K, k0 + BK, n0, tid, bvec);
    }
    warp_mma(As, Bs, wm, wn, lane, acc);
    __syncthreads();
  }
  for_each_acc(wm, wn, lane, acc, acc,
               [&](int r, int c, int v, int) { epi(m0 + r, n0 + c, v); });
}

// gemm_tile_a over row-major A codes [M, K].
template <typename Epi>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ A, int M, int K, int m0, bool avec,
    const int8_t* __restrict__ W, int N, int n0, bool bvec,
    int8_t (*As)[LDS], int8_t (*Bs)[LDS], Epi epi) {
  gemm_tile_a(
      [=](int k0) { return load_a(A, M, K, m0, k0, threadIdx.x, avec); }, K,
      m0, W, N, n0, bvec, As, Bs, epi);
}

// 16-byte vector loads need the row stride and the base address aligned.
inline bool vec16(const void* p, int ld) {
  return ld % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The whole-block tail, over 64x64 tiles in a grid stride: out[M, N] =
// T((f32(A @ W) - bias0) * scale + bias + f32(res)), each step rounded
// where the plain version rounds (bias and res may be null). A [M, K]
// codes with 16-byte rows (avec), W [K, N].
template <typename T>
__device__ void out_stage(int8_t (*As)[LDS], int8_t (*Bs)[LDS],
                          const int8_t* A, int M, int K, bool avec,
                          const int8_t* W, int N, bool bvec,
                          const float* scale, const float* bias0,
                          const float* bias, const T* res, T* out) {
  const int nt = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * nt;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    gemm_tile(A, M, K, tile / nt * BM, avec, W, N, tile % nt * BN, bvec, As,
              Bs, [&](int m, int n, int acc) {
                if (m >= M || n >= N) return;
                const size_t i = static_cast<size_t>(m) * N + n;
                float y = __fmul_rn(__fsub_rn(__int2float_rn(acc), bias0[n]),
                                    scale[n]);
                if (bias) y = __fadd_rn(y, bias[n]);
                if (res) y = __fadd_rn(y, to_f32(res[i]));
                store_f32(out + i, y);
              });
}

static inline int tiles64(int M, int N) {
  return (M + BM - 1) / BM * ((N + BN - 1) / BN);
}

// The largest grid that the card holds at once (a cooperative launch
// needs every block resident) of `Kernel` at `threads` a block and `smem`
// bytes of dynamic shared memory, and no more blocks than tiles. The SM
// count and the kernel's occupancy are queried once per device (the
// first 64 devices; 0 past them, which the launch refuses).
template <auto Kernel>
static int cooperative_grid(int threads, int smem, int tiles) {
  static std::atomic<int> held[64];  // blocks the card holds; 0: not asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int n = held[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads,
                                                  smem);
    n = sms * per_sm;
    held[dev].store(n, std::memory_order_relaxed);
  }
  return tiles < n ? tiles : n;
}

}  // namespace mixdq
