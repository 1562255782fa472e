// Whole-attention int8 kernels of the attn_impl="auto" path.
//
// Replaces mixdq_tpu/ops/pallas_sec_attention.py:sec_attention (pallas_call
// at :151), :sec_attention_q (:271), :sec_attention_qkv (:460),
// :sec_attention_qkv_out (:757, bodies _sec_qkv_out_kernel :503 and
// _sec_qkv_lnout_kernel :525) and :sec_attention_q_out (:927). All end in
// the JAX _attend_codes (:37-69), per head:
//
//   s = (q . k^T) * scale           f32 logits, scale after the dot
//   m = max_j s                     over ALL keys before any exp
//   p = exp(s - m); l = sum_j p     l from the f32 p
//   o = (bf16(p) . v) / l           p cast to v's dtype, divided, not
//   codes = quantize(o)             multiplied by 1/l
//
// The TPU kernels hold a whole [Tq, Tk] f32 logits tile in VMEM and carry
// to_out's int32 sum across the head grid. On Hopper each kernel but
// sec_attention is one cooperative launch of grid-stride stages separated
// by grid syncs, every block resident (one an SM: 8 warps, 128 KB of
// dynamic shared memory that every stage reuses):
//
//   LN     (LN-folded whole-block kernels) LayerNorm + the projection's
//          act-quantize of every row into a codes workspace, a warp a row
//          (common.cuh:ln_rows, ln_quantize's rows, in the ring's memory)
//   proj   the to_q GEMM [C_in, C], or the fused QKV GEMM [C, 3C], into a
//          q (k's dtype) or q | k | v (bf16) workspace:
//          T((f32(acc) - bias0) * scale)
//   attn   (batch, head, 64-row) items, one or two at once a block, into
//          to_out's codes (a codes workspace, or the output)
//   out    (whole-block kernels) the to_out GEMM [C, C_in] with bias and
//          residual (the raw input in LN-folded mode) in the model dtype:
//          T((f32(acc) - bias0) * scale + bias + f32(res)), one tile
//          summing the whole C (the TPU's head-panel int32 sum)
//
//   sec_attention_q        proj (to_q), attn over the fused to_kv output
//   sec_attention_qkv      proj (QKV), attn
//   sec_attention_q_out    [LN], proj (to_q), attn, out
//   sec_attention_qkv_out  [LN], proj (QKV), attn, out
//
// The GEMM stages run the int8 mainloop of igemm_s8.cuh (128 x 128 tiles,
// a 4-stage cp.async ring of 128-byte k steps, B kept [k][n]), the blocks
// walking the (tile, split) items of each stage's plan
// (ops/sec_attention.py:sec_plan, qmm_plan per GEMM) in a grid stride;
// split partials are summed by each tile's last block through the
// per-tile counters within the stage. At T=256 C=1280 on 132 SMs the
// to_q, QKV and to_out stages are 100, 120 and 100 items of 2 or 5 k steps
// (the pre-Hopper 64 x 64 tiles ran 80 / 240 / 80 tiles of 40 serial 32-
// byte steps). Int32 sums are exact in any split, so the q / qkv
// workspaces and to_out's output equal T(...) of the plain int products
// bit for bit.
//
// The attention stage gives each group of 4 warps (named barrier, 128
// threads) one 64-row item, warp w rows 16 w ..+16; k and v come through
// the key ring of attn_mma.cuh (KCH-key stages, cp.async, ldmatrix /
// ldmatrix.trans fragments). Where the items outnumber the blocks, two
// groups a block share its shared memory; else one group a block has all
// 128 KB. Where every key fits its share (d = 64: Tk <= 224 on 64 KB,
// 448 on 128 KB: the cross-attention's 77 text tokens, T=256 self) k and
// v are copied once and both passes read them in place; else they stream
// as in flash attention, STAGES - 1 chunks in flight: k for the max pass,
// then k and v for the p pass. Keys go in ascending 16-key mma steps in the same per-thread
// mapping as ever, so l and p.v sum in the same order: to_out's codes are
// the pre-ring kernels' bit for bit. f32 q/k/v (f32 models) take a scalar
// path, a warp per 16 rows.
//
// sec_attention (SDXL 1024's 32x32 attn1 and 64x64 attn2): a plain launch
// of the attention stage, a 128-thread block (one group) an item.
//
// Sources: the stages and the cooperative kernels are sec_attention.cuh;
// sec_coop_d16.cu .. sec_coop_d128.cu export the cooperative kernels of
// one head dim each (their nvcc runs in parallel); this file exports
// sec_attention.
//
// Bounds (1,979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s): T=256 C=1280
// (20 heads) q_out: the weight bytes, 3.3 MB, ~1 us; T=1024 C=640 qkv:
// 2.5 GOP of int8 and 2.7 GFLOP of bf16, ~4 us.

#include "sec_attention.cuh"

// ---------------------------------------------------------------------------
// sec_attention: the attention stage alone, a 128-thread block an item
// ---------------------------------------------------------------------------

// Blocks an SM is built for: three 64 KB rings (<= 170 registers a
// thread), two at d = 128.
template <typename T, int D>
__global__ void __launch_bounds__(GROUP_THREADS, D == 128 ? 2 : 3)
    sec_attn_kernel(const AttnArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_stage<T, D>(smem, a, 1, GROUP_SMEM);
}

template <typename T, int D>
static int launch_attn(const AttnArgs<T>& a, cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  static const cudaError_t attrs =
      BF16 ? igemm::set_smem(sec_attn_kernel<T, D>, GROUP_SMEM) : cudaSuccess;
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const int grid = a.B * a.heads * ((a.Tq + 63) / 64);
  sec_attn_kernel<T, D>
      <<<grid, GROUP_THREADS, BF16 ? GROUP_SMEM : 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int attn(const void* q, const void* k, const void* v, int ldq,
                int ldk, int ldv, int8_t* out, int B, int Tq, int Tk,
                int heads, int d, float sm_scale, Quant oq,
                cudaStream_t stream) {
  const AttnArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), out, ldq, ldk, ldv, B, Tq,
                      Tk, heads, sm_scale, oq};
  switch (d) {
    case 16: return launch_attn<T, 16>(a, stream);
    case 32: return launch_attn<T, 32>(a, stream);
    case 64: return launch_attn<T, 64>(a, stream);
    case 128: return launch_attn<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mixdq_sec_attention(const void* q, const void* k,
                                   const void* v, int ldq, int ldk, int ldv,
                                   int8_t* out, int B, int Tq, int Tk,
                                   int heads, int d, int is_bf16,
                                   float sm_scale, float sinv, float zp,
                                   float lo, float hi, cudaStream_t stream) {
  auto fn = is_bf16 ? attn<bf16> : attn<float>;
  return fn(q, k, v, ldq, ldk, ldv, out, B, Tq, Tk, heads, d, sm_scale,
            Quant{sinv, zp, lo, hi}, stream);
}
