// Shared helpers of the port's kernels (one shared library per source).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

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

// The LayerNorm statistics of row xr (C values of T, in device or shared
// memory) by one warp, as ops/ln_quant.py:ln_quantize_plain: lane l sums
// channels l, l + 32, ... in turn (sum and sum of squares in f32), then
// warp_sum's tree, then one-pass E[x^2] - mean^2 in _rn steps. Every
// LayerNorm row of the port sums here, so that its scalar loads and its
// shared-memory rows give the same codes bit for bit (a lane summing 8
// contiguous channels would move the mean's last ulp). Returns (mean,
// rstd).
template <typename T>
__device__ __forceinline__ float2 ln_stats(const T* __restrict__ xr, int C,
                                           float eps, int lane) {
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = __fdiv_rn(s, static_cast<float>(C));
  const float var = __fsub_rn(__fdiv_rn(ss, static_cast<float>(C)),
                              __fmul_rn(mean, mean));
  return make_float2(mean, rsqrtf(__fadd_rn(var, eps)));
}

// LayerNorm of one row + per-tensor quantize, by one warp: ln_stats, then
// the second pass re-reads the row from L1/L2; one load a lane in flight
// (ln_quantize's scalar kernel and ln_rows' scalar path).
template <typename T>
__device__ __forceinline__ void ln_quant_row(const T* __restrict__ xr,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             int8_t* __restrict__ orow,
                                             int C, float sinv, float zp,
                                             float lo, float hi, float eps,
                                             int lane) {
  const float2 st = ln_stats(xr, C, eps, lane);
  const float mean = st.x, rstd = st.y;
  for (int c = lane; c < C; c += 32) {
    float y = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
    y = __fadd_rn(__fmul_rn(y, gamma[c]), beta[c]);
    orow[c] = quant_code(y, sinv, zp, lo, hi);
  }
}

// The rows of ln_quant_row's function with every load in flight
// (ln_quantize, and the LN stages of geglu_out_qmatmul and of the
// whole-block sec_attention* kernels): a block's shared
// memory holds gamma and beta (f32 [C] each) and one row of T a warp
// (ln_smem_bytes), every copy a 16-byte cp.async (gamma and beta through
// L1, which the SM's other blocks then hit). The block copies gamma and
// beta and each warp its first row, all before the first wait; a
// warp's later rows land the same way, one round trip each. A row is
// then summed from shared memory by ln_stats, as ln_quant_row sums (the
// codes bit for bit), and normalized from shared memory 8 channels a
// lane, their 8 codes stored at once.
inline size_t ln_smem_bytes(int C, int warps, int elem_bytes) {
  return static_cast<size_t>(C) * (2 * sizeof(float) + warps * elem_bytes);
}

// The shared-memory rows need C % 8 == 0, x / gamma / beta on 16 bytes
// and codes on 8 (then every row is).
inline bool ln_row_vec(const void* x, const float* gamma, const float* beta,
                       const int8_t* codes, int C) {
  auto on = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return C % 8 == 0 && on(x, 16) && on(gamma, 16) && on(beta, 16) &&
         on(codes, 8);
}

// The calling warp's copies of row xr (C values of T) into srow.
template <typename T>
__device__ __forceinline__ void ln_copy_row(T* srow, const T* xr, int C,
                                            int lane) {
  const int chunks = C * static_cast<int>(sizeof(T)) / 16;
  const uint32_t dst = mixdq::smem_addr(srow);
  const char* src = reinterpret_cast<const char*>(xr);
  for (int q = lane; q < chunks; q += 32)
    mixdq::cp_async16(dst + 16 * q, src + 16 * q, true);
}

// 8 values of a row in shared memory (16-byte aligned): one 16-byte load
// (bf16; the widening is exact) or two (f32).
__device__ __forceinline__ void load8_shared(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8_shared(const __nv_bfloat16* p,
                                             float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// One landed row srow (shared) into orow, with gamma / beta in shared
// memory (gs, bs), by one warp.
template <typename T>
__device__ __forceinline__ void ln_quant_row_smem(
    const T* srow, const float* gs, const float* bs,
    int8_t* __restrict__ orow, int C, float sinv, float zp, float lo,
    float hi, float eps, int lane) {
  const float2 st = ln_stats(srow, C, eps, lane);
  const float mean = st.x, rstd = st.y;
  for (int c0 = 8 * lane; c0 < C; c0 += 256) {
    float v[8], g[8], b[8];
    load8_shared(srow + c0, v);
    load8_shared(gs + c0, g);
    load8_shared(bs + c0, b);
    uint32_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = __fmul_rn(__fsub_rn(v[j], mean), rstd);
      y = __fadd_rn(__fmul_rn(y, g[j]), b[j]);
      q[j] = static_cast<uint32_t>(quant_code(y, sinv, zp, lo, hi));
    }
    *reinterpret_cast<uint2*>(orow + c0) = make_uint2(
        __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                    __byte_perm(q[2], q[3], 0x0040), 0x5410),
        __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                    __byte_perm(q[6], q[7], 0x0040), 0x5410));
  }
}

// Rows row0, row0 + step, ... below M of x [M, C] into codes by the
// calling warp; every thread of the block calls it (one barrier). vec:
// ln_row_vec, and smem holds ln_smem_bytes(C, blockDim.x / 32,
// sizeof(T)); else ln_quant_row's scalar loads (a ragged C, a view off
// 16 bytes, rows wider than the caller's shared memory), with the same
// codes.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        int8_t* __restrict__ codes, int M,
                                        int C, float sinv, float zp,
                                        float lo, float hi, float eps,
                                        bool vec, unsigned char* smem,
                                        int row0, int step) {
  const int lane = threadIdx.x & 31;
  if (!vec) {
    for (int r = row0; r < M; r += step)
      ln_quant_row(x + static_cast<size_t>(r) * C, gamma, beta,
                   codes + static_cast<size_t>(r) * C, C, sinv, zp, lo, hi,
                   eps, lane);
    return;
  }
  float* gs = reinterpret_cast<float*>(smem);
  float* bs = gs + C;
  T* srow = reinterpret_cast<T*>(bs + C) + (threadIdx.x >> 5) * C;
  const uint32_t gd = mixdq::smem_addr(gs), bd = mixdq::smem_addr(bs);
  for (int q = threadIdx.x; q < C / 4; q += blockDim.x) {
    mixdq::cp_async16_ca(gd + 16 * q, gamma + 4 * q);
    mixdq::cp_async16_ca(bd + 16 * q, beta + 4 * q);
  }
  if (row0 < M)
    ln_copy_row(srow, x + static_cast<size_t>(row0) * C, C, lane);
  mixdq::cp_async_commit();
  mixdq::cp_async_wait<0>();
  __syncthreads();
  for (int r = row0; r < M; r += step) {
    if (r != row0) {
      __syncwarp();  // every lane is done with the last row
      ln_copy_row(srow, x + static_cast<size_t>(r) * C, C, lane);
      mixdq::cp_async_commit();
      mixdq::cp_async_wait<0>();
      __syncwarp();
    }
    ln_quant_row_smem(srow, gs, bs, codes + static_cast<size_t>(r) * C, C,
                      sinv, zp, lo, hi, eps, lane);
  }
}
