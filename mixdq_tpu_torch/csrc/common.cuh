// Shared helpers of the port's kernels (one shared library per source).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* mixdq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Per-tensor activation quantize, as qops.quantize_per_tensor:
// clip(rint(y * scale_inv) + zp, lo, hi); rint rounds half to even. The
// _rn intrinsics keep nvcc from contracting into an FMA, so each step
// rounds where the plain PyTorch version rounds.
__device__ __forceinline__ int8_t quant_code(float y, float sinv, float zp,
                                             float lo, float hi) {
  float q = __fadd_rn(rintf(__fmul_rn(y, sinv)), zp);
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row + per-tensor quantize, by one warp, as
// ops/ln_quant.py:ln_quantize_plain: lanes stride over the channels, sum
// and sum of squares reduce with shuffles (one-pass E[x^2] - mean^2 in
// f32), and the second pass re-reads the row from L1/L2.
template <typename T>
__device__ __forceinline__ void ln_quant_row(const T* __restrict__ xr,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             int8_t* __restrict__ orow,
                                             int C, float sinv, float zp,
                                             float lo, float hi, float eps,
                                             int lane) {
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = __fdiv_rn(s, static_cast<float>(C));
  const float var = __fsub_rn(__fdiv_rn(ss, static_cast<float>(C)),
                              __fmul_rn(mean, mean));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  for (int c = lane; c < C; c += 32) {
    float y = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
    y = __fadd_rn(__fmul_rn(y, gamma[c]), beta[c]);
    orow[c] = quant_code(y, sinv, zp, lo, hi);
  }
}

// Every row of x [M, C] through ln_quant_row, a warp per row, rows in a
// grid stride: the LN-folded stage of the whole-block kernels.
template <typename T>
__device__ __forceinline__ void ln_stage(const T* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         int8_t* __restrict__ codes, int M,
                                         int C, float sinv, float zp,
                                         float lo, float hi, float eps) {
  const int warps = blockDim.x / 32;
  for (int r = blockIdx.x * warps + threadIdx.x / 32; r < M;
       r += gridDim.x * warps)
    ln_quant_row(x + static_cast<size_t>(r) * C, gamma, beta,
                 codes + static_cast<size_t>(r) * C, C, sinv, zp, lo, hi, eps,
                 threadIdx.x & 31);
}
