// Fused GroupNorm (+ SiLU) + per-tensor int8 quantize.
//
// Replaces mixdq_tpu/ops/pallas_gn_quant.py:gn_silu_quantize (pallas_call
// at :147). Memory-bound: the input is read twice (stats, transform) and
// the codes written once; the bound counts one read + one write, 3 bytes
// per bf16 element (2.6 MB + 1.3 MB at [1, 4096, 320]).
//
// The TPU kernel carries per-channel sums across a sequential grid in
// VMEM scratch. Hopper blocks run in no order, so the sums become three
// short launches: (1) gn_partial: each block sums a chunk of rows for
// every channel (threads on neighbouring channels read neighbouring
// bytes); (2) gn_finalize: one block per batch element adds the chunks in
// a fixed order, folds channels into groups (contiguous C/G channels),
// and writes per-channel a = gamma * rstd and b = beta - mean * a (one-pass
// E[x^2] - mean^2 in f32, as the reference); (3) gn_apply: y = x * a + b,
// optional SiLU, quantize.

#include "common.cuh"

template <typename T>
__global__ void gn_partial(const T* __restrict__ x, float* __restrict__ part,
                           int N, int C, int rows_per_chunk) {
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int n0 = s * rows_per_chunk;
  const int n1 = min(N, n0 + rows_per_chunk);
  const T* xb = x + static_cast<size_t>(b) * N * C;
  float* pb = part + (static_cast<size_t>(b) * S + s) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f, sq = 0.f;
    for (int n = n0; n < n1; ++n) {
      float v = to_f32(xb[static_cast<size_t>(n) * C + c]);
      sum += v;
      sq += v * v;
    }
    pb[c] = sum;
    pb[C + c] = sq;
  }
}

__global__ void gn_finalize(const float* __restrict__ part,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            float* __restrict__ ab, int S, int N, int C,
                            int G, float eps) {
  extern __shared__ float sm[];  // [2C] channel sums, [2G] mean/rstd
  float* cs = sm;
  float* gs = sm + 2 * C;
  const int b = blockIdx.x;
  const float* pb = part + static_cast<size_t>(b) * S * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f, sq = 0.f;
    for (int s = 0; s < S; ++s) {
      sum += pb[s * 2 * C + c];
      sq += pb[s * 2 * C + C + c];
    }
    cs[c] = sum;
    cs[C + c] = sq;
  }
  __syncthreads();
  const int width = C / G;
  const float n = static_cast<float>(N) * static_cast<float>(width);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sum = 0.f, sq = 0.f;
    for (int j = 0; j < width; ++j) {
      sum += cs[g * width + j];
      sq += cs[C + g * width + j];
    }
    const float mean = __fdiv_rn(sum, n);
    const float var = __fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean));
    gs[g] = mean;
    gs[G + g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  float* abb = ab + static_cast<size_t>(b) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / width;
    const float a = __fmul_rn(gamma[c], gs[G + g]);
    abb[c] = a;
    abb[C + c] = __fsub_rn(beta[c], __fmul_rn(gs[g], a));
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ ab,
                         int8_t* __restrict__ out, size_t total, int N, int C,
                         int silu, float sinv, float zp, float lo, float hi) {
  const size_t per_batch = static_cast<size_t>(N) * C;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const float* abb = ab + (i / per_batch) * 2 * C;
    float y = __fadd_rn(__fmul_rn(to_f32(x[i]), abb[c]), abb[C + c]);
    if (silu) {
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y)));
      y = __fmul_rn(y, sig);
    }
    out[i] = quant_code(y, sinv, zp, lo, hi);
  }
}

extern "C" int mixdq_gn_quantize(const void* x, const float* gamma,
                                 const float* beta, int8_t* out, float* part,
                                 float* ab, int B, int N, int C, int G, int S,
                                 int x_bf16, int silu, float sinv, float zp,
                                 float lo, float hi, float eps,
                                 cudaStream_t stream) {
  const int rows_per_chunk = (N + S - 1) / S;
  const dim3 pgrid(S, B);
  const size_t total = static_cast<size_t>(B) * N * C;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  const int agrid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  const size_t fsmem = (2 * C + 2 * G) * sizeof(float);
  if (x_bf16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    gn_partial<<<pgrid, threads, 0, stream>>>(xp, part, N, C, rows_per_chunk);
    gn_finalize<<<B, threads, fsmem, stream>>>(part, gamma, beta, ab, S, N, C,
                                               G, eps);
    gn_apply<<<agrid, threads, 0, stream>>>(xp, ab, out, total, N, C, silu,
                                            sinv, zp, lo, hi);
  } else {
    const float* xp = static_cast<const float*>(x);
    gn_partial<<<pgrid, threads, 0, stream>>>(xp, part, N, C, rows_per_chunk);
    gn_finalize<<<B, threads, fsmem, stream>>>(part, gamma, beta, ab, S, N, C,
                                               G, eps);
    gn_apply<<<agrid, threads, 0, stream>>>(xp, ab, out, total, N, C, silu,
                                            sinv, zp, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
