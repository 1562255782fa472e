// Flash attention of the attn_impl="auto" path at Tq * Tk >= 2^22 (the
// self-attentions of SDXL 1024's 64x64 level, 10 heads of 64, and of
// SD1.5 512's, 8 heads of 40; in the W8A8 and the bf16 UNet), and of
// every site under attn_impl="flash" (SD1.5: heads of 40 / 80 / 160).
//
// Replaces mixdq_tpu/ops/pallas_attention.py:flash_attention (pallas_call
// at :106; mha :135 feeds it head-major copies). Per head, over key
// blocks of bk keys (mha's 1024, clipped to Tk rounded up to 128: the
// wrapper's flash_block_keys):
//
//   s = (q . k^T) * scale              f32, keys >= Tk masked to -1e30
//   m' = max(m, max_j s)               m starts at -1e30
//   alpha = exp(m - m'); p = exp(s - m')
//   l = l alpha + sum_j p              l from the f32 p
//   acc = acc alpha + bf16(p) . v      p cast to v's dtype, f32 acc
//   out = acc / l                      in q's dtype
//
// The bf16 rounding of p is relative to the running max after each key
// block, so the result depends on the partition, and the kernel keeps the
// reference's. The TPU kernel carries m, l and acc in VMEM scratch along
// a sequential key grid axis. Here one block owns (batch, head, 64 query
// rows), warp w rows 16 w ..+16, and walks the key blocks in a loop with
// m, l and acc in registers. 64 rows' f32 logits of a key block (256 KB)
// do not fit in shared memory, so each block's keys stream through twice:
// a first pass takes the block's row max from the logits, m, l and acc
// are rescaled once, and a second pass recomputes the same logits to form
// p and PV (recomputing QK^T costs less than writing and reading the
// logits through shared memory). QK^T and PV run on mma.sync m16n8k16
// (bf16 x bf16 -> f32). q/k/v are read in place at their column offsets
// with their sources' row strides (the fused to_qkv output), and the
// output is written [B, Tq, heads * d] for to_out: no head-major copies.
// f32 q/k/v take a scalar path, a warp per row, over the same blocks.
//
// Bound at T=4096, 10 heads, d=64: the two QK^T passes and PV are 6 T^2 d
// heads = 64 GFLOP of bf16 tensor-core work, ~0.065 ms at the dense peak
// (the function itself needs 4 T^2 d, ~0.043 ms); the bytes (q/k/v and
// out, ~21 MB) take ~6 us. The exact expf and the bf16 packing of p
// (168 M logits at B=1) load the ALU and conversion pipes beside the
// tensor cores. The bf16 path keeps 3 chunks of k (and v) in flight
// through a cp.async ring (see "The bf16 path" below) and reads fragments
// by ldmatrix.
//
// Waves: at B=1 the grid is 10 heads x 64 row tiles = 640 blocks of 4
// warps. Each holds 36 KB of ring (4 stages x 32 keys x 2 x 72 bf16) and
// is built for <= 128 registers a thread, so 4 blocks fit on an SM: 528
// slots on 132 SMs, 1.21 waves, 4.85 blocks per SM (B=2: 1280 blocks,
// 2.4 waves). Built for 5 blocks an SM (one wave at B=1, <= 96
// registers) it spilled, so the spill-free 4 was chosen. At d = 128 the
// ring is 68 KB and 2 blocks fit on an SM.
//
// Head dims 40, 80 and 160 (SD1.5's 8 heads at 320 / 640 / 1280
// channels; the TPU kernel zero-pads any d to 128 lanes): the ring pads
// d to the next multiple of the mma's 16-deep step (40 -> 48), zeroing
// the pad in every stage (attn_mma.cuh:KvStage), so QK^T and PV run
// whole m16n8k16 steps and the output writes d columns. At SD1.5 512's
// flash site (B=1, T=4096, 8 heads of 40) the grid is 512 blocks, one
// wave at 4 blocks an SM; the function needs 4 T^2 d heads = 21.5 GFLOP,
// ~0.022 ms at the dense peak, and the padded kernel does 6 T^2 48 heads.
//
// int8_flash_attention and int8qkv_flash_attention run on the same key
// ring (ChunkCursor, attn_mma.cuh): int8_flash.cu.

#include "attn_mma.cuh"

using namespace mixdq;

// threads of the f32 path's blocks: a warp per 16 of 64 rows
constexpr int THREADS = 128;

template <typename T>
struct FlashArgs {
  const T* q;  // row 0, column q_off, of batch element 0
  const T* k;
  const T* v;
  T* out;  // [B*Tq, heads*D]
  int ldq, ldk, ldv, B, Tq, Tk, heads, bk;
  float scale;
};

// The bf16 path: a block owns (batch, head, BQ = 64 query rows), warp w
// rows 16 w ..+16, q fragments in registers for both passes. k and v
// stream through the key ring of attn_mma.cuh, STAGES stages of KCH keys
// in dynamic shared memory, filled in the order the passes read them: per
// key block, its chunks of k for the max pass, then the same chunks of k
// and v for the p pass. So the copies of the next STAGES - 1 chunks are in
// flight while one is multiplied, across the switch between passes and
// between key blocks.
constexpr int BQ = 64;     // query rows per block: a warp per 16
constexpr int FT = BQ / 16 * 32;  // threads per block
constexpr int STAGES = 4;  // ring stages: 3 chunks in flight
static_assert(FT == GROUP_THREADS, "one ring group a block");

template <int D>
struct FlashRing {
  static constexpr int BYTES = STAGES * KvStage<D>::BYTES;
  // blocks per SM the kernel is built for, as many as its registers
  // allow without spills (<= 96 a thread at d <= 32, <= 128 at d = 40
  // and 64, <= 168 at d = 80, <= 255 at d = 128 and 160); shared memory
  // would allow 6 / 8 / 6 / 5 / 3 / 2
  static constexpr int MIN_BLOCKS =
      D <= 32 ? 5 : D <= 64 ? 4 : D <= 80 ? 3 : 2;
};

// Block-wide: the cursor's chunk into the ring stage at shared address
// `st` (keys >= Tk zero), then one commit group (empty once the cursor is
// done).
template <int D>
__device__ __forceinline__ void issue_chunk(uint32_t st,
                                            const HeadPanels<bf16>& h,
                                            int ldk, int ldv, int Tk,
                                            const ChunkCursor& cur) {
  if (cur.j0 < Tk)
    copy_kv_chunk<D>(st, h, ldk, ldv, Tk, cur.c0, cur.pass != 0, threadIdx.x);
  cp_async_commit();
}

// One head over bf16 q/k/v for a BQ-row tile (nq valid rows) into out
// (the tile's first row, the head's first column; row stride ldo), over
// key blocks of bk keys (a multiple of KCH); ring: the shared address of
// the STAGES stages.
template <int D>
__device__ void flash_bf16(uint32_t ring, const HeadPanels<bf16>& h, bf16* out,
                           int ldq, int ldk, int ldv, int ldo, int nq, int Tk,
                           int bk, float scale) {
  constexpr int STAGE = KvStage<D>::BYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows

  ChunkCursor fill{0, 0, 0};
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    issue_chunk<D>(ring + i * STAGE, h, ldk, ldv, Tk, fill);
    fill.next(Tk, bk);
  }
  constexpr int DP = KvStage<D>::DP;  // d padded to the mma's depth
  uint32_t qf[DP / 16][4];
  load_q_frags<D>(qf, h.q, ldq, ra, rb, nq, t);

  // The next stage once its copies have landed; the stage consumed before
  // it (every warp is past it) is refilled from the cursor.
  int stage = 0;
  auto next_stage = [&]() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue_chunk<D>(ring + (stage == 0 ? STAGES - 1 : stage - 1) * STAGE, h,
                   ldk, ldv, Tk, fill);
    fill.next(Tk, bk);
    const uint32_t st = ring + stage * STAGE;
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    return st;
  };

  float s[KCH / 8][4];
  float o[DP / 8][4] = {};
  // running max of rows ra / rb (the same in the row's four threads) and
  // this thread's share of their running sums
  float ma = MASKED, mb = MASKED, la = 0.f, lb = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += bk) {
    const int jend = min(j0 + bk, Tk);
    float ca = MASKED, cb = MASKED;  // pass 1: the block's row max
    for (int c0 = j0; c0 < jend; c0 += KCH) {
      ring_logits<D>(next_stage(), qf, s, lane);
      const int live = Tk - c0;  // keys of the stage below Tk
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (live < KCH && nt * 8 + 2 * t + (r & 1) >= live) continue;
          const float v = __fmul_rn(s[nt][r], scale);
          if (r < 2) ca = fmaxf(ca, v);
          else cb = fmaxf(cb, v);
        }
    }
    const float na = fmaxf(ma, quad_max(ca)), nb = fmaxf(mb, quad_max(cb));
    const float aa = expf(__fsub_rn(ma, na)), ab = expf(__fsub_rn(mb, nb));
    ma = na;
    mb = nb;
    la = __fmul_rn(la, aa);
    lb = __fmul_rn(lb, ab);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      o[dt][0] = __fmul_rn(o[dt][0], aa);
      o[dt][1] = __fmul_rn(o[dt][1], aa);
      o[dt][2] = __fmul_rn(o[dt][2], ab);
      o[dt][3] = __fmul_rn(o[dt][3], ab);
    }
    for (int c0 = j0; c0 < jend; c0 += KCH) {  // pass 2: p, l, p.v
      const uint32_t st = next_stage();
      ring_logits<D>(st, qf, s, lane);
      const int live = Tk - c0;
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = 0.f;
          if (live >= KCH || nt * 8 + 2 * t + (r & 1) < live)
            p = expf(__fsub_rn(__fmul_rn(s[nt][r], scale), r < 2 ? na : nb));
          s[nt][r] = p;
          if (r < 2) la += p;
          else lb += p;
        }
      ring_pv<D>(st + KvStage<D>::V, s, o, lane);
    }
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

template <int D>
__global__ void __launch_bounds__(FT, FlashRing<D>::MIN_BLOCKS)
    flash_bf16_kernel(const FlashArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char flash_ring[];
  const int rt = (a.Tq + BQ - 1) / BQ, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * BQ;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(BQ, a.Tq - r * BQ), ldo = a.heads * D;
  const HeadPanels<bf16> hp{a.q + row0 * a.ldq + h * D,
                            a.k + key0 * a.ldk + h * D,
                            a.v + key0 * a.ldv + h * D, nullptr};
  flash_bf16<D>(smem_addr(flash_ring), hp,
                a.out + row0 * ldo + h * D, a.ldq, a.ldk, a.ldv, ldo, nq,
                a.Tk, a.bk, a.scale);
}

// f32 q/k/v: the scalar path, a warp per 16 rows of a 64-row tile.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_f32_kernel(const FlashArgs<float> a) {
  const int rt = (a.Tq + 63) / 64, tile = blockIdx.x;
  const int r = tile % rt, h = tile / rt % a.heads, b = tile / rt / a.heads;
  const size_t row0 = static_cast<size_t>(b) * a.Tq + r * 64;
  const size_t key0 = static_cast<size_t>(b) * a.Tk;
  const int nq = min(64, a.Tq - r * 64), ldo = a.heads * D;
  const size_t w0 = row0 + (threadIdx.x >> 5) * 16;
  const int ldq = a.ldq, ldk = a.ldk;
  const float scale = a.scale;
  const float* q = a.q + w0 * ldq + h * D;
  const float* k = a.k + key0 * ldk + h * D;
  flash_rows_f32<D>(
      [=](int i, int j) {
        return __fmul_rn(dot_f32(q + static_cast<size_t>(i) * ldq,
                                 k + static_cast<size_t>(j) * ldk, D),
                         scale);
      },
      a.v + key0 * a.ldv + h * D, a.out + w0 * ldo + h * D, a.ldv, ldo,
      max(0, min(16, nq - static_cast<int>(threadIdx.x >> 5) * 16)), a.Tk,
      a.bk);
}

// The ring's dynamic shared memory (above 48 KB at d = 128) and the
// largest carveout, so that MIN_BLOCKS blocks fit on an SM; once per
// kernel.
template <int D>
static cudaError_t flash_bf16_attrs() {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FlashRing<D>::BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(flash_bf16_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
static int launch_flash(const FlashArgs<bf16>& a, cudaStream_t stream) {
  static const cudaError_t attrs = flash_bf16_attrs<D>();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const int grid = a.B * a.heads * ((a.Tq + BQ - 1) / BQ);
  flash_bf16_kernel<D><<<grid, FT, FlashRing<D>::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_flash(const FlashArgs<float>& a, cudaStream_t stream) {
  const int grid = a.B * a.heads * ((a.Tq + 63) / 64);
  flash_f32_kernel<D><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int flash(const void* q, const void* k, const void* v, void* out,
                 int ldq, int ldk, int ldv, int B, int Tq, int Tk, int heads,
                 int d, int bk, float scale, cudaStream_t stream) {
  // the bf16 path walks a block in whole chunks of KCH keys
  if (bk <= 0 || bk % 64) return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(out), ldq,
                       ldk, ldv, B, Tq, Tk, heads, bk, scale};
  switch (d) {
    case 16: return launch_flash<16>(a, stream);
    case 32: return launch_flash<32>(a, stream);
    case 40: return launch_flash<40>(a, stream);
    case 64: return launch_flash<64>(a, stream);
    case 80: return launch_flash<80>(a, stream);
    case 128: return launch_flash<128>(a, stream);
    case 160: return launch_flash<160>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
extern "C" int mixdq_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int ldq,
                                     int ldk, int ldv, int B, int Tq, int Tk,
                                     int heads, int d, int bk, int is_bf16,
                                     float scale, cudaStream_t stream) {
  auto fn = is_bf16 ? flash<bf16> : flash<float>;
  return fn(q, k, v, out, ldq, ldk, ldv, B, Tq, Tk, heads, d, bk, scale,
            stream);
}
