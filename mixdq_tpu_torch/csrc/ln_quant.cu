// Fused LayerNorm + per-tensor int8 quantize.
//
// Replaces mixdq_tpu/ops/pallas_ln_quant.py:ln_quantize (pallas_call at
// :82). Memory-bound: it reads the bf16 row once from device memory
// (2 bytes/elem) and writes int8 codes (1 byte/elem); at the main-path
// shapes [1024, 640] and [256, 1280] that is ~1 MB, ~0.3 us at
// 3.35 TB/s. One warp owns one row (common.cuh:ln_quant_row): one-pass
// E[x^2] - mean^2 variance in f32, as the reference.

#include "common.cuh"

template <typename T>
__global__ void ln_quant_kernel(const T* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int8_t* __restrict__ out, int rows, int C,
                                float sinv, float zp, float lo, float hi,
                                float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  ln_quant_row(x + static_cast<size_t>(row) * C, gamma, beta,
               out + static_cast<size_t>(row) * C, C, sinv, zp, lo, hi, eps,
               threadIdx.x % 32);
}

extern "C" int mixdq_ln_quantize(const void* x, const float* gamma,
                                 const float* beta, int8_t* out, int rows,
                                 int C, int x_bf16, float sinv, float zp,
                                 float lo, float hi, float eps,
                                 cudaStream_t stream) {
  const int threads = 256;
  const int grid = (rows + threads / 32 - 1) / (threads / 32);
  if (x_bf16) {
    ln_quant_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta, out, rows, C,
        sinv, zp, lo, hi, eps);
  } else {
    ln_quant_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(x), gamma, beta, out, rows, C, sinv, zp,
        lo, hi, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
