// The stages of the whole-attention int8 kernels (sec_attention.cu says
// what each computes and how) and the four cooperative kernels built from
// them. A source that defines SEC_HEAD_DIM before including this header
// (sec_coop_d16.cu .. sec_coop_d128.cu) exports the cooperative kernels
// at that head dim, so that the four compile in parallel.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "attn_mma.cuh"
#include "igemm_s8.cuh"

namespace cg = cooperative_groups;
using namespace mixdq;
using igemm::BSrc;
using igemm::EpiArgs;

struct Quant {
  float sinv, zp, lo, hi;
};

// A streaming group's key ring: half the block's shared memory, as many
// KCH-key stages of k and v as fit (at most 8): 8 / 8 / 7 / 3 at d = 16 /
// 32 / 64 / 128.
constexpr int GROUP_SMEM = igemm::SMEM / 2;
template <int D>
struct AttnRing {
  static constexpr int FIT = GROUP_SMEM / KvStage<D>::BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static_assert(STAGES >= 3, "two chunks in flight");
};

__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(GROUP_THREADS)
               : "memory");
}

// One head over bf16 q/k/v for a 64-row item (nq valid rows) by the
// group `group` of 4 warps (named barrier 1 + group) on the ring_bytes of
// shared memory at shared address `ring` (at least GROUP_SMEM): every key
// in place where they fit, else streamed; writes the quantized o to
// h.out.
template <int D>
__device__ void attend_bf16(uint32_t ring, int ring_bytes, int group,
                            const HeadPanels<bf16>& h, int ldq, int ldk,
                            int ldv, int ldo, int nq, int Tk, float scale,
                            Quant oq) {
  constexpr int STAGES = AttnRing<D>::STAGES, STAGE = KvStage<D>::BYTES;
  const int gtid = threadIdx.x & (GROUP_THREADS - 1);
  const int lane = gtid & 31, warp = gtid >> 5, bar = 1 + group;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows
  const int chunks = (Tk + KCH - 1) / KCH;
  const bool resident = chunks * STAGE <= ring_bytes;

  group_sync(bar);  // every warp of the group is done with the last item
  // streaming: fills 0 .. chunks-1 are k (max pass), then k and v
  int fill = 0;
  auto issue = [&](int slot) {
    if (fill < 2 * chunks) {
      const int c = fill < chunks ? fill : fill - chunks;
      copy_kv_chunk<D>(ring + slot * STAGE, h, ldk, ldv, Tk, c * KCH,
                       fill >= chunks, gtid);
    }
    cp_async_commit();
    ++fill;
  };
  if (resident) {
    for (int c = 0; c < chunks; ++c)
      copy_kv_chunk<D>(ring + c * STAGE, h, ldk, ldv, Tk, c * KCH, true,
                       gtid);
    cp_async_commit();
  } else {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(i);
  }
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, h.q, ldq, ra, rb, nq, t);
  if (resident) {
    cp_async_wait<0>();
    group_sync(bar);
  }
  // Chunk c of a pass: in place (resident), or the ring's next stage once
  // its copies have landed, the stage consumed before it (every warp of
  // the group is past it) refilled.
  int stage = 0;
  auto next_stage = [&](int c) -> uint32_t {
    if (resident) return ring + c * STAGE;
    cp_async_wait<STAGES - 2>();
    group_sync(bar);
    issue(stage == 0 ? STAGES - 1 : stage - 1);
    const uint32_t st = ring + stage * STAGE;
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    return st;
  };

  float s[KCH / 8][4];
  float ma = -INFINITY, mb = -INFINITY;
  for (int c = 0; c < chunks; ++c) {  // pass 1: row max over all keys
    ring_logits<D>(next_stage(c), qf, s, lane);
    const int live = Tk - c * KCH;  // keys of the chunk below Tk
#pragma unroll
    for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (live < KCH && nt * 8 + 2 * t + (r & 1) >= live) continue;
        const float v = __fmul_rn(s[nt][r], scale);
        if (r < 2) ma = fmaxf(ma, v);
        else mb = fmaxf(mb, v);
      }
  }
  ma = quad_max(ma);
  mb = quad_max(mb);

  float la = 0.f, lb = 0.f;
  float o[D / 8][4] = {};
  for (int c = 0; c < chunks; ++c) {  // pass 2: p, l, p.v
    const uint32_t st = next_stage(c);
    ring_logits<D>(st, qf, s, lane);
    const int live = Tk - c * KCH;
#pragma unroll
    for (int nt = 0; nt < KCH / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = 0.f;
        if (live >= KCH || nt * 8 + 2 * t + (r & 1) < live)
          p = expf(__fsub_rn(__fmul_rn(s[nt][r], scale), r < 2 ? ma : mb));
        s[nt][r] = p;
        if (r < 2) la += p;
        else lb += p;
      }
    ring_pv<D>(st + KvStage<D>::V, s, o, lane);
  }
  cp_async_wait<0>();  // streaming: the empty groups past the last fill
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

// ---------------------------------------------------------------------------
// Stages
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

// Attention items (batch element, head, 64 query rows) in a grid stride,
// one at a time per group of 4 warps: up to max_groups groups a block
// where the items outnumber the blocks, each on its share of the
// smem_bytes of dynamic shared memory, else one group a block on all of
// it (so that more keys stay in place). q rows of batch element b start
// at q + b Tq ldq, k/v at k + b Tk ldk.
template <typename T, int D>
__device__ void attn_stage(unsigned char* smem, const AttnArgs<T>& a,
                           int max_groups, int smem_bytes) {
  const int group = threadIdx.x / GROUP_THREADS;
  const int rt = (a.Tq + 63) / 64, items = a.B * a.heads * rt;
  const int groups = items > static_cast<int>(gridDim.x) ? max_groups : 1;
  const int ring_bytes = smem_bytes / groups;
  const int ldo = a.heads * D;
  for (int it = blockIdx.x + group * gridDim.x; it < items;
       it += groups * gridDim.x) {
    const int r = it % rt, h = it / rt % a.heads, b = it / rt / a.heads;
    const size_t row0 = static_cast<size_t>(b) * a.Tq + r * 64;
    const size_t key0 = static_cast<size_t>(b) * a.Tk;
    const int nq = min(64, a.Tq - r * 64);
    if constexpr (std::is_same<T, bf16>::value) {
      const HeadPanels<bf16> hp{a.q + row0 * a.ldq + h * D,
                                a.k + key0 * a.ldk + h * D,
                                a.v + key0 * a.ldv + h * D,
                                a.out + row0 * ldo + h * D};
      attend_bf16<D>(smem_addr(smem) + group * ring_bytes, ring_bytes, group,
                     hp, a.ldq, a.ldk, a.ldv, ldo, nq, a.Tk, a.sm_scale,
                     a.oq);
    } else {  // a warp per 16 rows
      const int w16 = (threadIdx.x / 32 % (GROUP_THREADS / 32)) * 16;
      const HeadPanels<float> hp{a.q + (row0 + w16) * a.ldq + h * D,
                                 a.k + key0 * a.ldk + h * D,
                                 a.v + key0 * a.ldv + h * D,
                                 a.out + (row0 + w16) * ldo + h * D};
      attend_f32<D>(hp, a.ldq, a.ldk, a.ldv, ldo, max(0, min(16, nq - w16)),
                    a.Tk, a.sm_scale, a.oq);
    }
  }
}

// One int8 GEMM stage: codes a [M, K] x b [K, N] with e's epilogue, over
// splits of split_k (splits 0: no such stage).
struct GemmStage {
  const int8_t* a;
  int K;
  bool avec;  // K a multiple of 16 and a on 16 bytes
  BSrc b;
  EpiArgs e;
  int splits, split_k;
};

// The stage's (tile, split) items in a grid stride through igemm's
// mainloop (a split's partial summed by its tile's last block).
template <typename T, bool FAST>
__device__ void gemm_stage(const GemmStage& g, int* ws, unsigned* counters) {
  const int nt = (g.e.N + igemm::BN - 1) / igemm::BN;
  const int tiles = (g.e.M + igemm::BM - 1) / igemm::BM * nt;
  igemm::DenseA<FAST> a{g.a, g.e.M, g.K, g.avec, {nullptr, nullptr}};
  for (int item = blockIdx.x; item < tiles * g.splits; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int m0 = tile / nt * igemm::BM, n0 = tile % nt * igemm::BN;
    __syncthreads();  // every warp is done with the last item's ring
    a.init(m0);
    igemm::run_tile<T, FAST, false>(a, g.b, g.e, g.K, m0, n0, tile, split,
                                    g.splits, g.split_k, ws, counters);
  }
}

// Block 0 writes the global timer (ns) into stamps[i] (null: off): the
// stage split of ops/sec_attention.py:probe.
__device__ __forceinline__ void stage_stamp(unsigned long long* stamps,
                                            int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
    stamps[i] = ns;
  }
}

// ---------------------------------------------------------------------------
// The cooperative kernels
// ---------------------------------------------------------------------------

// TQ: q/k/v's type (k's dtype; bf16 after the fused QKV GEMM), TO: the
// model dtype (the LN input, the residual and the output).
template <typename TQ, typename TO>
struct CoopArgs {
  const TO* x;  // raw input (LN-folded mode) or null
  const float* gamma;
  const float* beta;
  int8_t* codes;  // [M, proj.K]: written in LN-folded mode, else input
  float eps;
  Quant xq;
  int ln;
  bool ln_vec;     // the LN stage on shared-memory rows (ln_rows)
  GemmStage proj;  // codes -> the q or q | k | v workspace (TQ)
  AttnArgs<TQ> attn;
  GemmStage out;  // to_out's codes -> out (TO)
  int* ws;
  unsigned* counters;
  unsigned long long* stamps;  // [5] or null
};

// [LN], proj, attn, [out] (OUT: the whole-block kernels), the stamps
// after each (a grid sync closing every stage while they are on).
template <typename TQ, typename TO, int D, bool FAST, bool OUT>
__device__ __forceinline__ void coop_body(const CoopArgs<TQ, TO>& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  stage_stamp(a.stamps, 0);
  if constexpr (OUT) {
    if (a.ln) {
      constexpr int warps = igemm::NT / 32;
      ln_rows(a.x, a.gamma, a.beta, a.codes, a.proj.e.M, a.proj.K,
              a.xq.sinv, a.xq.zp, a.xq.lo, a.xq.hi, a.eps, a.ln_vec, smem,
              blockIdx.x * warps + threadIdx.x / 32, gridDim.x * warps);
      grid.sync();
    }
  }
  stage_stamp(a.stamps, 1);
  gemm_stage<TQ, FAST>(a.proj, a.ws, a.counters);
  grid.sync();
  stage_stamp(a.stamps, 2);
  attn_stage<TQ, D>(smem, a.attn, 2, igemm::SMEM);
  if (OUT || a.stamps) grid.sync();
  stage_stamp(a.stamps, 3);
  if constexpr (OUT) {
    gemm_stage<TO, FAST>(a.out, a.ws, a.counters);
    if (a.stamps) grid.sync();
  }
  stage_stamp(a.stamps, 4);
}

// One kernel a function, so that a profile tells them apart.
template <typename TQ, typename TO, int D, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    sec_q_kernel(const CoopArgs<TQ, TO> a) {
  coop_body<TQ, TO, D, FAST, false>(a);
}
template <typename TQ, typename TO, int D, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    sec_qkv_kernel(const CoopArgs<TQ, TO> a) {
  coop_body<TQ, TO, D, FAST, false>(a);
}
template <typename TQ, typename TO, int D, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    sec_q_out_kernel(const CoopArgs<TQ, TO> a) {
  coop_body<TQ, TO, D, FAST, true>(a);
}
template <typename TQ, typename TO, int D, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    sec_qkv_out_kernel(const CoopArgs<TQ, TO> a) {
  coop_body<TQ, TO, D, FAST, true>(a);
}

// The kernel of C entry `kind` (ops/sec_attention.py: 0 sec_attention_q,
// 1 _qkv, 2 _q_out, 3 _qkv_out) for these types, or null where it takes
// others: q / q_out keep q in the model dtype; qkv / qkv_out have bf16
// q | k | v, and qkv a bf16 model.
template <typename TQ, typename TO, int D, bool FAST>
static const void* coop_kernel(int kind) {
  constexpr bool SAME = std::is_same<TQ, TO>::value;
  constexpr bool QBF16 = std::is_same<TQ, bf16>::value;
  if constexpr (SAME) {
    if (kind == 0) return reinterpret_cast<const void*>(
        sec_q_kernel<TQ, TO, D, FAST>);
    if (kind == 2) return reinterpret_cast<const void*>(
        sec_q_out_kernel<TQ, TO, D, FAST>);
  }
  if constexpr (QBF16) {
    if (kind == 3) return reinterpret_cast<const void*>(
        sec_qkv_out_kernel<TQ, TO, D, FAST>);
    if constexpr (SAME)
      if (kind == 1) return reinterpret_cast<const void*>(
          sec_qkv_kernel<TQ, TO, D, FAST>);
  }
  return nullptr;
}

// The ring's shared memory, set once per kernel.
template <typename TQ, typename TO, int D, bool FAST>
static cudaError_t coop_attrs(int kind) {
  auto set = [](int k) {
    const void* f = coop_kernel<TQ, TO, D, FAST>(k);
    return f ? igemm::set_smem(f) : cudaErrorInvalidValue;
  };
  static const cudaError_t err[4] = {set(0), set(1), set(2), set(3)};
  return kind >= 0 && kind < 4 ? err[kind] : cudaErrorInvalidValue;
}

template <typename TQ, typename TO, int D, bool FAST>
static int coop_launch(int kind, const CoopArgs<TQ, TO>& a, int grid,
                       cudaStream_t stream) {
  const cudaError_t attrs = coop_attrs<TQ, TO, D, FAST>(kind);
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  void* args[] = {const_cast<CoopArgs<TQ, TO>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      coop_kernel<TQ, TO, D, FAST>(kind), dim3(grid), dim3(igemm::NT), args,
      igemm::SMEM, stream));
}

static bool gemm_fast(const GemmStage& g) {
  return g.splits == 0 || (g.avec && g.b.mode == igemm::B_COPY16);
}

// The 16-byte copies known at compile time (FAST) where every GEMM stage
// takes them in a bf16 model; f32 models (the test-size UNets) take the
// run-time copy modes.
template <typename TQ, typename TO, int D>
static int coop_any(int kind, const CoopArgs<TQ, TO>& a, int grid,
                    cudaStream_t stream) {
  if constexpr (std::is_same<TO, bf16>::value)
    if (gemm_fast(a.proj) && gemm_fast(a.out))
      return coop_launch<TQ, TO, D, true>(kind, a, grid, stream);
  return coop_launch<TQ, TO, D, false>(kind, a, grid, stream);
}

template <typename TQ, typename TO, int D>
static int coop(int kind, const void* x, const float* gamma,
                const float* beta, int8_t* codes, float eps, Quant xq, int ln,
                const GemmStage& proj, const void* q, int ldq, const void* k,
                int ldk, const void* v, int ldv, int8_t* o, int B, int Tq,
                int Tk, int heads, float sm_scale, Quant mq,
                const GemmStage& out, int* ws, unsigned* counters,
                unsigned long long* stamps, int grid, cudaStream_t stream) {
  const bool ln_vec =
      ln && ln_row_vec(x, gamma, beta, codes, proj.K) &&
      ln_smem_bytes(proj.K, igemm::NT / 32, sizeof(TO)) <= igemm::SMEM;
  const CoopArgs<TQ, TO> a{
      static_cast<const TO*>(x), gamma, beta, codes, eps, xq, ln, ln_vec,
      proj,
      AttnArgs<TQ>{static_cast<const TQ*>(q), static_cast<const TQ*>(k),
                   static_cast<const TQ*>(v), o, ldq, ldk, ldv, B, Tq, Tk,
                   heads, sm_scale, mq},
      out, ws, counters, stamps};
  return coop_any<TQ, TO, D>(kind, a, grid, stream);
}

static GemmStage gemm(const int8_t* a, int M, int K, const int8_t* w, int N,
                      const float* scale, const float* bias0,
                      const float* bias, const void* res, void* out,
                      int splits, int split_k) {
  const bool res_vec =
      res != nullptr && reinterpret_cast<uintptr_t>(res) % 16 == 0;
  return GemmStage{a, K, vec16(a, K), BSrc{w, N, igemm::b_mode(w, N)},
                   EpiArgs{scale, bias0, bias, nullptr, res, out, M, N, 1,
                           false, false, res_vec},
                   splits, split_k};
}

// Blocks of one instantiation's kernels an SM holds at once (the least
// over its kinds), with the ring's shared memory; 0 on an error.
template <typename TQ, typename TO, int D, bool FAST>
static int coop_per_sm() {
  int least = 1 << 30;
  for (int kind = 0; kind < 4; ++kind) {
    const void* f = coop_kernel<TQ, TO, D, FAST>(kind);
    int n = 0;
    if (f == nullptr) continue;
    if (coop_attrs<TQ, TO, D, FAST>(kind) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, f, igemm::NT, igemm::SMEM) != cudaSuccess)
      return 0;
    least = std::min(least, n);
  }
  return least;
}

#ifdef SEC_HEAD_DIM
// Every cooperative sec_attention* kernel at head dim SEC_HEAD_DIM:
//   kind: 0 sec_attention_q, 1 _qkv, 2 _q_out, 3 _qkv_out
//   x, gamma, beta, x_*, eps (ln; the whole-block kinds): the LN-folded
//     input [M, Kp] and its act quantizer; codes [M, Kp]: the proj codes
//     (written when ln)
//   wp [Kp, Np], sp / b0p [Np] -> qws [M, Np] in q's type (q_bf16)
//   q / k / v (row strides ldq / ldk / ldv, head h at column h d): the
//     attention's panels (in qws, or the fused to_kv output); o [M, heads
//     d]: to_out's codes (mid_* quantizer)
//   the whole-block kinds: wout [heads d, Cout], so / b0o [Cout], bo
//     [Cout] or null, res [M, Cout] or null (the raw input x in LN-folded
//     mode) -> out [M, Cout] in the model dtype (out_bf16)
//   bm, stages, splits / split_k of proj and out: sec_plan's qmm_plans;
//   ws / counters: their int32 workspace and zeroed counters (split
//   plans); grid: sec_plan's, at most the blocks the card holds
//   (mixdq_sec_attention_per_sm an SM); stamps: int64 [5] or null
extern "C" int mixdq_sec_attention_coop(
    int kind, const void* x, const float* gamma, const float* beta,
    int8_t* codes, const int8_t* wp, const float* sp, const float* b0p,
    void* qws, const void* q, int ldq, const void* k, int ldk,
    const void* v, int ldv, int8_t* o, const int8_t* wout, const float* so,
    const float* b0o, const float* bo, const void* res, void* out, int* ws,
    unsigned* counters, unsigned long long* stamps, int B, int Tq, int Tk,
    int Kp, int Np, int Cout, int heads, int d, int q_bf16, int out_bf16,
    int ln, float sm_scale, float mid_sinv, float mid_zp, float mid_lo,
    float mid_hi, float x_sinv, float x_zp, float x_lo, float x_hi,
    float eps, int bm, int stages, int proj_splits, int proj_split_k,
    int out_splits, int out_split_k, int grid, cudaStream_t stream) {
  constexpr int D = SEC_HEAD_DIM;
  const bool whole = kind >= 2;
  const int M = B * Tq, C = heads * D;
  if (d != D ||
      !igemm::plan_ok(bm, stages, proj_splits, proj_split_k, Kp, ws,
                      counters) ||
      (whole && !igemm::plan_ok(bm, stages, out_splits, out_split_k, C, ws,
                                counters)) ||
      grid < 1 || (!q_bf16 && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmStage proj = gemm(codes, M, Kp, wp, Np, sp, b0p, nullptr,
                              nullptr, qws, proj_splits, proj_split_k);
  const GemmStage tail =
      whole ? gemm(o, M, C, wout, Cout, so, b0o, bo, ln ? x : res, out,
                   out_splits, out_split_k)
            : GemmStage{};
  const Quant xq{x_sinv, x_zp, x_lo, x_hi};
  const Quant mq{mid_sinv, mid_zp, mid_lo, mid_hi};
  auto fn = !q_bf16 ? coop<float, float, D>
            : out_bf16 ? coop<bf16, bf16, D>
                       : coop<bf16, float, D>;
  return fn(kind, x, gamma, beta, codes, eps, xq, whole && ln, proj, q, ldq,
            k, ldk, v, ldv, o, B, Tq, Tk, heads, sm_scale, mq, tail, ws,
            counters, stamps, grid, stream);
}

// Blocks of the cooperative kernels one SM holds at once (the least over
// their instantiations); 0 on an error.
extern "C" int mixdq_sec_attention_per_sm(void) {
  constexpr int D = SEC_HEAD_DIM;
  return std::min(std::min(coop_per_sm<bf16, bf16, D, true>(),
                           coop_per_sm<bf16, bf16, D, false>()),
                  std::min(coop_per_sm<float, float, D, false>(),
                           coop_per_sm<bf16, float, D, false>()));
}
#endif  // SEC_HEAD_DIM
