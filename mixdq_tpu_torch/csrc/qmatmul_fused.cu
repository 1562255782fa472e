// W8A8 GEMMs with the activation quantize fused in: bf16 activations in,
// s8 codes formed inside the kernel, int8 mma.sync, int32 bias0 epilogue.
//
// Replace mixdq_tpu/ops/pallas_qmatmul.py:qmatmul_fused (pallas_call at
// :760, body _fused_kernel :135) and :qmatmul_fused2 (pallas_call :263,
// body _fused2_kernel :161). Both compute, for bf16 x [M, K] (rows of
// stride ldx; the wrapper casts other dtypes first, as the JAX wrappers
// do), s8 weights w [K, N] and f32 [N] scale / bias0:
//
//   codes = clip(rint(f32(x) * scale_inv) + zp_shifted, -128, 127)   s8
//   acc   = codes @ w                                                s32
//   out   = f32(acc - int32(bias0)) * scale          -> bf16 or f32 [M, N]
//
// bias0 is truncated to int32 and subtracted in int32, as the Pallas
// kernels do (qmatmul.cu subtracts in f32). The codes of K tails meet the
// zero weight rows the B loader reads at or past K, which add 0, where
// JAX pads x with zeros against zero rows of w. The int32 sums are exact
// in any split and order, so both kernels equal the plain version
// (ops/qmatmul.py:qmatmul_fused_plain) bit for bit.
//
// Both run the int8 mainloop of igemm_s8.cuh (128 x 128 tiles of 8 warps,
// a 4-stage cp.async ring of 128-byte k steps, B kept [k][n] and
// transposed in registers, split-K planned by ops/qmatmul.py:qmm_plan and
// reduced by each tile's last block in the same launch) with its
// INT_BIAS0 epilogue.
//
// qmatmul_fused keeps the TPU kernel's schedule, quantizing in every
// output tile: its A loader (igemm::QuantA) copies each step's 128 x 128
// bf16 x tile with cp.async into a ring stage beside the B tile (4 x 48
// KB), and the block quantizes the next step's landed x tile shared ->
// shared into one of two code stages while it multiplies the current
// one (igemm::mainloop_quant; 224 KB of shared memory). Each x element is
// quantized N / 128 times (10 at N = 1280) and x read as often from L2.
//
// qmatmul_fused2 quantizes each element once per call (the TPU v2
// kernel's point), in one cooperative launch of two phases: the grid
// quantizes x in a grid stride into an int8 codes workspace [M, ldc]
// (ldc = K rounded up to 16; 5.2 MB at 1024 x 5120, resident in the 50 MB
// L2), then, after a grid sync, the blocks walk the plan's (tile, split)
// items in a grid stride through the mainloop's dense A loader. The grid
// (ops/qmatmul.py:fused2_grid) holds no more blocks than the card holds
// at once, and no block waits on another but at the grid sync, so no K
// and no shape can deadlock it; K is not limited.
//
// Bound at M=1024 K=5120 N=1280 (ff.net.2 at SDXL 1024's 32x32 level):
// 13.4 G int8 operations, ~6.8 us at 1,979 TOP/s; 19.7 MB in and out,
// ~5.9 us at 3.35 TB/s.

#include <cooperative_groups.h>

#include <algorithm>

#include "igemm_s8.cuh"

using namespace mixdq;
using igemm::BSrc;
using igemm::EpiArgs;
namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

template <typename T, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    qmatmul_fused_kernel(igemm::QuantA<FAST> a, BSrc b, EpiArgs e, int K,
                         int split_k, int* ws, unsigned* counters) {
  a.init(blockIdx.y * igemm::BM);
  igemm::run_block<T, FAST, true>(a, b, e, K, split_k, ws, counters);
}

// Phase 1 of qmatmul_fused2: x [M, K] (rows of stride ldx) -> codes
// [M, ldc], 8 codes an item, items row-major in a grid stride, four
// items' loads in flight a thread. Codes at or past K are those of 0.
__device__ __forceinline__ void quantize_rows(const bf16* __restrict__ x,
                                              int ldx, int M, int K,
                                              int8_t* __restrict__ codes,
                                              int ldc, float sinv, float zp,
                                              bool zint, bool xvec) {
  const int per_row = ldc / 8;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // a row-major cursor (r, c) advanced by the stride without division
  int r = static_cast<int>(first / per_row);
  int c = static_cast<int>(first % per_row);
  const int dr = static_cast<int>(stride / per_row);
  const int dc = static_cast<int>(stride % per_row);
  while (r < M) {
    uint4 v[4];
    int rr[4], cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rr[u] = r;
      cc[u] = c;
      if (r < M)
        v[u] = igemm::load8_bf16(x + static_cast<size_t>(r) * ldx + 8 * c,
                                 K - 8 * c, xvec);
      r += dr;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (rr[u] < M)
        *reinterpret_cast<uint2*>(codes + static_cast<size_t>(rr[u]) * ldc +
                                  8 * cc[u]) =
            igemm::quant8_bf16(v[u], sinv, zp, zint);
  }
}

struct Fused2Args {
  const bf16* x;
  int ldx;
  int8_t* codes;  // [M, ldc]
  int ldc, K;
  float sinv, zp;
  bool zint, xvec;
  int split_k, splits;
  int* ws;
  unsigned* counters;
};

template <typename T, bool FAST>
__global__ void __launch_bounds__(igemm::NT, 1)
    qmatmul_fused2_kernel(const Fused2Args f, const BSrc b, const EpiArgs e) {
  quantize_rows(f.x, f.ldx, e.M, f.K, f.codes, f.ldc, f.sinv, f.zp, f.zint,
                f.xvec);
  cg::this_grid().sync();
  const int nt = (e.N + igemm::BN - 1) / igemm::BN;
  const int tiles = (e.M + igemm::BM - 1) / igemm::BM * nt;
  igemm::DenseA<FAST> a{f.codes, e.M, f.ldc, true, {nullptr, nullptr}};
  for (int item = blockIdx.x; item < tiles * f.splits; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int m0 = tile / nt * igemm::BM, n0 = tile % nt * igemm::BN;
    __syncthreads();  // every warp is done with the last item's ring
    a.init(m0);
    igemm::run_tile<T, FAST, true>(a, b, e, f.K, m0, n0, tile, split,
                                   f.splits, f.split_k, f.ws, f.counters);
  }
}

// The ring's shared memory, set once per kernel.
template <typename T, bool FAST>
static cudaError_t fused_attrs() {
  static const cudaError_t err =
      igemm::set_smem(qmatmul_fused_kernel<T, FAST>, igemm::QSMEM);
  return err;
}
template <typename T, bool FAST>
static cudaError_t fused2_attrs() {
  static const cudaError_t err =
      igemm::set_smem(qmatmul_fused2_kernel<T, FAST>);
  return err;
}

template <typename T, bool FAST>
static int fused_launch(const igemm::QuantA<FAST>& a, const BSrc& b,
                        const EpiArgs& e, int K, int splits, int split_k,
                        int* ws, unsigned* counters, cudaStream_t stream) {
  const cudaError_t attrs = fused_attrs<T, FAST>();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((e.N + igemm::BN - 1) / igemm::BN,
                  (e.M + igemm::BM - 1) / igemm::BM, splits);
  qmatmul_fused_kernel<T, FAST><<<grid, igemm::NT, igemm::QSMEM, stream>>>(
      a, b, e, K, split_k, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [M, K] rows of stride ldx; the 16-byte loads and copies known at
// compile time (FAST), or chosen at run time.
template <typename T>
static int fused(const bf16* x, int ldx, const BSrc& b, const EpiArgs& e,
                 int K, float sinv, float zp, int splits, int split_k,
                 int* ws, unsigned* counters, cudaStream_t stream) {
  const bool xvec = ldx % 8 == 0 && K % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool zint = igemm::zp_integral(zp);
  if (xvec && b.mode == igemm::B_COPY16) {
    const igemm::QuantA<true> a{x, e.M, ldx, sinv, zp, zint, true, 0};
    return fused_launch<T, true>(a, b, e, K, splits, split_k, ws, counters,
                                 stream);
  }
  const igemm::QuantA<false> a{x, e.M, ldx, sinv, zp, zint, xvec, 0};
  return fused_launch<T, false>(a, b, e, K, splits, split_k, ws, counters,
                                stream);
}

template <typename T, bool FAST>
static int fused2_launch(const Fused2Args& f, const BSrc& b,
                         const EpiArgs& e, int grid, cudaStream_t stream) {
  const cudaError_t attrs = fused2_attrs<T, FAST>();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  void* args[] = {const_cast<Fused2Args*>(&f), const_cast<BSrc*>(&b),
                  const_cast<EpiArgs*>(&e)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(qmatmul_fused2_kernel<T, FAST>), dim3(grid),
      dim3(igemm::NT), args, igemm::SMEM, stream));
}

template <typename T>
static int fused2(const Fused2Args& f, const BSrc& b, const EpiArgs& e,
                  int grid, cudaStream_t stream) {
  return b.mode == igemm::B_COPY16
             ? fused2_launch<T, true>(f, b, e, grid, stream)
             : fused2_launch<T, false>(f, b, e, grid, stream);
}

// Blocks of one qmatmul_fused2 instantiation an SM holds at once.
template <typename T, bool FAST>
static int fused2_per_sm() {
  int n = 0;
  if (fused2_attrs<T, FAST>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, qmatmul_fused2_kernel<T, FAST>, igemm::NT, igemm::SMEM) !=
          cudaSuccess)
    return 0;
  return n;
}

static EpiArgs fused_epi(const float* scale, const float* bias0, void* out,
                         int M, int N) {
  return EpiArgs{scale, bias0, nullptr, nullptr, nullptr, out, M, N, 1,
                 false, false, false};
}

// x bf16 [M, K] (rows of stride ldx), w [K, N] int8, scale / bias0 [N]
// f32, out [M, N] bf16 or f32. bm, stages, splits, split_k: the plan of
// ops/qmatmul.py:qmm_plan; ws: int32 [tiles, splits, 128, 128] and
// counters: tiles zeroed uint32 when splits > 1.
extern "C" int mixdq_qmatmul_fused(const void* x, int ldx, const int8_t* w,
                                   const float* scale, const float* bias0,
                                   void* out, int* ws, unsigned* counters,
                                   int M, int K, int N, float sinv, float zp,
                                   int out_bf16, int bm, int stages,
                                   int splits, int split_k,
                                   cudaStream_t stream) {
  if (!igemm::plan_ok(bm, stages, splits, split_k, K, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const BSrc b{w, N, igemm::b_mode(w, N)};
  const EpiArgs e = fused_epi(scale, bias0, out, M, N);
  return out_bf16 ? fused<bf16>(xb, ldx, b, e, K, sinv, zp, splits, split_k,
                                ws, counters, stream)
                  : fused<float>(xb, ldx, b, e, K, sinv, zp, splits, split_k,
                                 ws, counters, stream);
}

// As mixdq_qmatmul_fused, with codes: the int8 workspace [M, ldc]
// (ops/qmatmul.py:fused2_codes_shape; 16-byte rows, ldc >= K) and grid:
// the cooperative grid (ops/qmatmul.py:fused2_grid), at most the blocks
// the card holds at once (mixdq_qmatmul_fused2_per_sm per SM).
extern "C" int mixdq_qmatmul_fused2(const void* x, int ldx, const int8_t* w,
                                    const float* scale, const float* bias0,
                                    void* out, int8_t* codes, int ldc,
                                    int* ws, unsigned* counters, int M,
                                    int K, int N, float sinv, float zp,
                                    int out_bf16, int bm, int stages,
                                    int splits, int split_k, int grid,
                                    cudaStream_t stream) {
  if (!igemm::plan_ok(bm, stages, splits, split_k, K, ws, counters) ||
      grid < 1 || ldc < K || !vec16(codes, ldc))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const Fused2Args f{xb, ldx, codes, ldc, K, sinv, zp,
                     igemm::zp_integral(zp),
                     ldx % 8 == 0 && K % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0,
                     split_k, splits, ws, counters};
  const BSrc b{w, N, igemm::b_mode(w, N)};
  const EpiArgs e = fused_epi(scale, bias0, out, M, N);
  return out_bf16 ? fused2<bf16>(f, b, e, grid, stream)
                  : fused2<float>(f, b, e, grid, stream);
}

// Blocks of qmatmul_fused2 one SM holds at once (the least over its four
// instantiations), with its ring's shared memory; 0 on an error.
extern "C" int mixdq_qmatmul_fused2_per_sm(void) {
  const int n[4] = {fused2_per_sm<bf16, true>(), fused2_per_sm<bf16, false>(),
                    fused2_per_sm<float, true>(),
                    fused2_per_sm<float, false>()};
  return std::min(std::min(n[0], n[1]), std::min(n[2], n[3]));
}
