// Fused LayerNorm + per-tensor int8 quantize.
//
// Replaces mixdq_tpu/ops/pallas_ln_quant.py:ln_quantize (pallas_call at
// :82). Memory-bound: it reads the bf16 row once from device memory
// (2 bytes/elem) and writes int8 codes (1 byte/elem); at the main-path
// shapes [1024, 640] and [256, 1280] that is ~1 MB, ~0.3 us at
// 3.35 TB/s, below what one launch costs. One-pass E[x^2] - mean^2
// variance in f32, as the reference.
//
// Design: one warp a row (common.cuh:ln_rows): the row, gamma and beta
// land in shared memory through 16-byte copies all in flight at once;
// the row is summed from there in the reference order and normalized
// from there 8 channels a lane (8-byte code stores). Two warps a block,
// so that the rows spread over the card (at [1, 256, 1280], 128 blocks on
// 132 SMs). Ragged C, a view off 16 bytes or a row wider than a block's
// shared memory take ln_quant_row's scalar loads (ln_quant_scalar_kernel,
// eight warps a block), with the same codes. Its time at the UNet's
// shapes is within a few us of an empty kernel's (chip_smoke.py's launch
// floor; PERF.md).

#include "common.cuh"

// rows a block: LN_WARPS on the shared-memory rows, LN_SCALAR_WARPS on
// the scalar loads
constexpr int LN_WARPS = 2, LN_SCALAR_WARPS = 8;
// the largest dynamic shared memory of a block (227 KB)
constexpr int LN_MAX_SMEM = 232448;

template <typename T>
__global__ void __launch_bounds__(32 * LN_WARPS)
    ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ out,
                    int rows, int C, float sinv, float zp, float lo,
                    float hi, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  ln_rows(x, gamma, beta, out, rows, C, sinv, zp, lo, hi, eps, true, smem,
          blockIdx.x * LN_WARPS + threadIdx.x / 32, gridDim.x * LN_WARPS);
}

// The scalar loads, a kernel of their own: the same loop inside
// ln_quant_kernel ran at half this speed on an H100 (PERF.md).
template <typename T>
__global__ void __launch_bounds__(32 * LN_SCALAR_WARPS)
    ln_quant_scalar_kernel(const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           int8_t* __restrict__ out, int rows, int C,
                           float sinv, float zp, float lo, float hi,
                           float eps) {
  const int row = blockIdx.x * LN_SCALAR_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  ln_quant_row(x + static_cast<size_t>(row) * C, gamma, beta,
               out + static_cast<size_t>(row) * C, C, sinv, zp, lo, hi, eps,
               threadIdx.x & 31);
}

template <typename T>
static int ln_launch(const T* x, const float* gamma, const float* beta,
                     int8_t* out, int rows, int C, float sinv, float zp,
                     float lo, float hi, float eps, cudaStream_t stream) {
  static const cudaError_t attrs = cudaFuncSetAttribute(
      ln_quant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LN_MAX_SMEM);
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const size_t bytes = ln_smem_bytes(C, LN_WARPS, sizeof(T));
  if (ln_row_vec(x, gamma, beta, out, C) && bytes <= LN_MAX_SMEM)
    ln_quant_kernel<T>
        <<<(rows + LN_WARPS - 1) / LN_WARPS, 32 * LN_WARPS,
           static_cast<int>(bytes), stream>>>(x, gamma, beta, out, rows, C,
                                              sinv, zp, lo, hi, eps);
  else
    ln_quant_scalar_kernel<T>
        <<<(rows + LN_SCALAR_WARPS - 1) / LN_SCALAR_WARPS,
           32 * LN_SCALAR_WARPS, 0, stream>>>(x, gamma, beta, out, rows, C,
                                              sinv, zp, lo, hi, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mixdq_ln_quantize(const void* x, const float* gamma,
                                 const float* beta, int8_t* out, int rows,
                                 int C, int x_bf16, float sinv, float zp,
                                 float lo, float hi, float eps,
                                 cudaStream_t stream) {
  if (x_bf16)
    return ln_launch(static_cast<const __nv_bfloat16*>(x), gamma, beta, out,
                     rows, C, sinv, zp, lo, hi, eps, stream);
  return ln_launch(static_cast<const float*>(x), gamma, beta, out, rows, C,
                   sinv, zp, lo, hi, eps, stream);
}

// An empty kernel, one warp: what a launch costs the card whatever its
// work (chip_smoke.py times it beside ln_quantize).
__global__ void empty_kernel() {}

extern "C" int mixdq_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
