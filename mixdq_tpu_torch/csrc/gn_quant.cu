// Fused GroupNorm (+ SiLU) + per-tensor int8 quantize.
//
// Replaces mixdq_tpu/ops/pallas_gn_quant.py:gn_silu_quantize (pallas_call
// at :147). Memory-bound: the bound counts one read of x and one write of
// the codes, 3 bytes per bf16 element (2.6 MB + 1.3 MB at [1, 4096, 320]:
// ~1.2 us at 3.35 TB/s on an H100 SXM); x is read twice (stats, apply),
// the second time mostly from L2.
//
// The TPU kernel carries per-channel sums across a sequential grid in
// VMEM scratch. Hopper blocks run in no order, so the sums take three
// launches, each spread over the card:
// (1) gn_partial: the rows of each batch element in S (<= PART_SLOTS) chunks
//     of ceil(N / S) rows; one thread per (chunk, 2 channels) sums its
//     channels over the chunk's rows in row order. A thread issues the
//     loads of up to ROWS rows before it adds them, so that whole chunks
//     are in flight at once; grid (S, channel blocks, B) of 64 threads.
//     Partials are stored [B][2][C][PART_SLOTS] (sums, then squares).
// (2) gn_finalize: one block per (group, batch element): a thread per
//     (channel, sum or squares) loads its S partials (16-byte loads, all
//     at once) and adds them in chunk order; one lane each then adds the
//     group's channel sums in channel order; mean, one-pass E[x^2] -
//     mean^2 in f32, rstd; a = gamma * rstd, b = beta - mean * a per
//     channel. Every sum runs in a fixed order (rows within a chunk,
//     chunks, then the group's channels), so the codes do not depend on
//     the grid or on which block finishes first.
// (3) gn_apply: a thread per V channels (one 16-byte load of 8 bf16)
//     holds their a and b in registers for up to APPLY_ROWS rows, whose
//     loads it issues at once: y = x * a + b, optional SiLU, quantize, and
//     8 codes in one 8-byte store. The grid's threads are a multiple of
//     the channel vectors of a row, so a thread's channels are fixed.

#include <numeric>

#include "common.cuh"

constexpr int PART_SLOTS = 64;  // partials per (channel, sum or squares)
// gn_partial's loads in flight per thread: 64 or 128 bytes of x
template <typename T>
constexpr int ROWS = sizeof(T) == 2 ? 64 : 32;
constexpr int APPLY_ROWS = 4;   // rows of one gn_apply thread
constexpr int PART_THREADS = 64, FIN_THREADS = 256, APPLY_THREADS = 256;

// V consecutive values of x as stored, for one load (p aligned to V
// elements; 16 bytes at most a load).
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Vals {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ Vals<T, V> load_vals(const T* p) {
  return *reinterpret_cast<const Vals<T, V>*>(p);
}

// Programmatic dependent launch (Hopper): gn_finalize and gn_apply are
// launched while their predecessor runs and wait for it here (a no-op in
// a grid launched without the attribute); each predecessor lets them
// launch as soon as all its blocks are resident.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename T, int V>
__global__ void __launch_bounds__(PART_THREADS)
    gn_partial(const T* __restrict__ x, float* __restrict__ part, int N,
               int C, int rows_per_chunk) {
  allow_next_grid();
  const int s = blockIdx.x, b = blockIdx.z;
  const int c0 = (blockIdx.y * PART_THREADS + threadIdx.x) * V;
  if (c0 >= C) return;
  const int n0 = s * rows_per_chunk;
  const int n1 = min(N, n0 + rows_per_chunk);
  const T* xb = x + (static_cast<size_t>(b) * N + n0) * C + c0;
  const int rows = n1 - n0;
  float sum[V] = {}, sq[V] = {};
  for (int r0 = 0; r0 < rows; r0 += ROWS<T>) {
    // every load unconditional (rows past the chunk re-read its last), so
    // that all of them are issued before the first add waits
    Vals<T, V> v[ROWS<T>];
#pragma unroll
    for (int r = 0; r < ROWS<T>; ++r) {
      const int row = min(r0 + r, rows - 1);
      v[r] = load_vals<T, V>(xb + static_cast<size_t>(row) * C);
    }
#pragma unroll
    for (int r = 0; r < ROWS<T>; ++r)
      if (r0 + r < rows) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f32(v[r].e[j]);
          sum[j] += f;
          sq[j] += f * f;
        }
      }
  }
  float* pb = part + static_cast<size_t>(b) * 2 * C * PART_SLOTS;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    pb[(c0 + j) * PART_SLOTS + s] = sum[j];
    pb[(C + c0 + j) * PART_SLOTS + s] = sq[j];
  }
}

__global__ void __launch_bounds__(FIN_THREADS)
    gn_finalize(const float* __restrict__ part,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ ab,
                int S, int N, int C, int G, float eps) {
  extern __shared__ float cs[];  // [2][width]: the group's channel sums
  __shared__ float stat[2];      // mean, rstd
  allow_next_grid();
  wait_prior_grid();
  const int grp = blockIdx.x, b = blockIdx.y, width = C / G;
  const float* pb = part + static_cast<size_t>(b) * 2 * C * PART_SLOTS;
  for (int i = threadIdx.x; i < 2 * width; i += FIN_THREADS) {
    const int q = i / width, c = grp * width + i - q * width;
    const float4* p =
        reinterpret_cast<const float4*>(pb + (q * C + c) * PART_SLOTS);
    float4 v[PART_SLOTS / 4];
#pragma unroll
    for (int u = 0; u < PART_SLOTS / 4; ++u) v[u] = __ldcg(p + u);
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < PART_SLOTS / 4; ++u) {
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * u + j < S) acc += e[j];
    }
    cs[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float acc = 0.f;
    if (threadIdx.x < 2) {
#pragma unroll 8
      for (int j = 0; j < width; ++j) acc += cs[threadIdx.x * width + j];
    }
    const float sq = __shfl_sync(0xffffffffu, acc, 1);
    if (threadIdx.x == 0) {
      const float n = static_cast<float>(N) * static_cast<float>(width);
      const float mean = __fdiv_rn(acc, n);
      const float var = __fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean));
      stat[0] = mean;
      stat[1] = rsqrtf(__fadd_rn(var, eps));
    }
  }
  __syncthreads();
  float* abb = ab + static_cast<size_t>(b) * 2 * C;
  for (int j = threadIdx.x; j < width; j += FIN_THREADS) {
    const int c = grp * width + j;
    const float a = __fmul_rn(gamma[c], stat[1]);
    abb[c] = a;
    abb[C + c] = __fsub_rn(beta[c], __fmul_rn(stat[0], a));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_apply(const T* __restrict__ x, const float* __restrict__ ab,
             int8_t* __restrict__ out, int N, int C, int silu, float sinv,
             float zp, float lo, float hi) {
  const int cvs = C / V, b = blockIdx.y;
  const int tid = blockIdx.x * APPLY_THREADS + threadIdx.x;
  const int cv = tid % cvs, r0 = tid / cvs;
  const int pass = gridDim.x * APPLY_THREADS / cvs;  // rows a pass
  const int c0 = cv * V;
  const size_t base = static_cast<size_t>(b) * N * C + c0;
  // x does not depend on gn_finalize: its loads (unconditional, as in
  // gn_partial) go out before the wait
  Vals<T, V> v[APPLY_ROWS];
#pragma unroll
  for (int k = 0; k < APPLY_ROWS; ++k) {
    const int n = min(r0 + k * pass, N - 1);
    v[k] = load_vals<T, V>(x + base + static_cast<size_t>(n) * C);
  }
  wait_prior_grid();
  const float* abb = ab + static_cast<size_t>(b) * 2 * C;
  float a[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = abb[c0 + j];
    sh[j] = abb[C + c0 + j];
  }
#pragma unroll
  for (int k = 0; k < APPLY_ROWS; ++k) {
    const int n = r0 + k * pass;
    if (n >= N) continue;
    uint32_t q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = __fadd_rn(__fmul_rn(to_f32(v[k].e[j]), a[j]), sh[j]);
      if (silu) {
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y)));
        y = __fmul_rn(y, sig);
      }
      q[j] = static_cast<uint32_t>(quant_code(y, sinv, zp, lo, hi));
    }
    int8_t* o = out + base + static_cast<size_t>(n) * C;
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(o) = make_uint2(
          __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                      __byte_perm(q[2], q[3], 0x0040), 0x5410),
          __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                      __byte_perm(q[6], q[7], 0x0040), 0x5410));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = static_cast<int8_t>(q[j]);
    }
  }
}

static bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// gn_apply's blocks: enough that each thread has at most APPLY_ROWS rows,
// their threads a multiple of the cvs channel vectors of a row.
static int apply_blocks(int N, int cvs) {
  const int unit = cvs / std::gcd(APPLY_THREADS, cvs);
  const long long want =
      (static_cast<long long>(N) * cvs + APPLY_ROWS * APPLY_THREADS - 1) /
      (APPLY_ROWS * APPLY_THREADS);
  return static_cast<int>((want + unit - 1) / unit * unit);
}

// kernel<<<grid, block, smem, stream>>>(args...) as a programmatic
// dependent of the stream's previous kernel.
template <typename... P, typename... A>
static cudaError_t launch_dependent(void (*kernel)(P...), dim3 grid,
                                    int block, size_t smem,
                                    cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
static int gn_launch(const T* x, const float* gamma, const float* beta,
                     int8_t* out, float* part, float* ab, int B, int N, int C,
                     int G, int S, int silu, float sinv, float zp, float lo,
                     float hi, float eps, cudaStream_t stream) {
  const int rows_per_chunk = (N + S - 1) / S;
  const bool pair = C % 2 == 0 && aligned(x, 2 * sizeof(T));
  const int pv = pair ? 2 : 1;
  const dim3 pgrid(S, (C / pv + PART_THREADS - 1) / PART_THREADS, B);
  if (pair)
    gn_partial<T, 2><<<pgrid, PART_THREADS, 0, stream>>>(x, part, N, C,
                                                          rows_per_chunk);
  else
    gn_partial<T, 1><<<pgrid, PART_THREADS, 0, stream>>>(x, part, N, C,
                                                          rows_per_chunk);
  cudaError_t e = launch_dependent(
      gn_finalize, dim3(G, B), FIN_THREADS, 2 * (C / G) * sizeof(float),
      stream, part, gamma, beta, ab, S, N, C, G, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (C % 8 == 0 && aligned(x, 16) && aligned(out, 8))
    e = launch_dependent(gn_apply<T, 8>, dim3(apply_blocks(N, C / 8), B),
                         APPLY_THREADS, 0, stream, x, ab, out, N, C, silu,
                         sinv, zp, lo, hi);
  else
    e = launch_dependent(gn_apply<T, 1>, dim3(apply_blocks(N, C), B),
                         APPLY_THREADS, 0, stream, x, ab, out, N, C, silu,
                         sinv, zp, lo, hi);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x [B, N, C] bf16 or f32; part: f32 [B, 2, C, PART_SLOTS]; ab: f32
// [B, 2, C]; S <= PART_SLOTS row chunks (ops/gn_quant.py).
extern "C" int mixdq_gn_quantize(const void* x, const float* gamma,
                                 const float* beta, int8_t* out, float* part,
                                 float* ab, int B, int N, int C, int G, int S,
                                 int x_bf16, int silu, float sinv, float zp,
                                 float lo, float hi, float eps,
                                 cudaStream_t stream) {
  if (S < 1 || S > PART_SLOTS || G < 1 || C % G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return gn_launch(static_cast<const __nv_bfloat16*>(x), gamma, beta, out,
                     part, ab, B, N, C, G, S, silu, sinv, zp, lo, hi, eps,
                     stream);
  return gn_launch(static_cast<const float*>(x), gamma, beta, out, part, ab,
                   B, N, C, G, S, silu, sinv, zp, lo, hi, eps, stream);
}
