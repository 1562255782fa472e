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
