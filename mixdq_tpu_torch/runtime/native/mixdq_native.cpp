// mixdq_tpu_torch native host runtime: a copy of the JAX package's
// mixdq_tpu/runtime/native/mixdq_native.cpp. The device kernels live under
// csrc/; this library covers host hot paths:
//   * int4 <-> int8 pack/unpack (adjacent pairs, low nibble first, +8 bias:
//     the deploy container's layout, not the wq kernels' halves layout)
//   * threaded per-channel int8 weight quantization
//   * a simple tensor container writer (header + aligned raw blobs)
//
// C ABI only, bound from Python with ctypes (runtime/__init__.py), built
// with g++ at first use into runtime/build/.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// int4 packing: two signed 4-bit codes per byte (low nibble first).
// Values must be in [-8, 7]; stored biased by +8 in each nibble.
// ---------------------------------------------------------------------------

void pack_int4(const int8_t* src, uint8_t* dst, int64_t n) {
  int64_t pairs = n / 2;
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  int64_t chunk = (pairs + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(pairs, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        uint8_t a = (uint8_t)(src[2 * i] + 8) & 0xF;
        uint8_t b = (uint8_t)(src[2 * i + 1] + 8) & 0xF;
        dst[i] = (uint8_t)(a | (b << 4));
      }
    });
  }
  for (auto& th : ts) th.join();
  if (n % 2) {  // trailing element in its own byte, high nibble zeroed
    dst[pairs] = (uint8_t)(src[n - 1] + 8) & 0xF;
  }
}

void unpack_int4(const uint8_t* src, int8_t* dst, int64_t n) {
  int64_t pairs = n / 2;
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  int64_t chunk = (pairs + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(pairs, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        dst[2 * i] = (int8_t)(src[i] & 0xF) - 8;
        dst[2 * i + 1] = (int8_t)((src[i] >> 4) & 0xF) - 8;
      }
    });
  }
  for (auto& th : ts) th.join();
  if (n % 2) {
    dst[n - 1] = (int8_t)(src[pairs] & 0xF) - 8;
  }
}

// ---------------------------------------------------------------------------
// Threaded per-out-channel symmetric int8 quantization.
// w: [rows, cols] f32, delta: [cols] (out-channel last, flax layout).
// codes = clip(round(w / delta), lo, hi)
// ---------------------------------------------------------------------------

void quantize_per_channel(const float* w, const float* delta, int8_t* out,
                          int64_t rows, int64_t cols, int lo, int hi) {
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  int64_t chunk = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t r0 = t * chunk, r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back([=]() {
      for (int64_t r = r0; r < r1; ++r) {
        const float* wr = w + r * cols;
        int8_t* orow = out + r * cols;
        for (int64_t c = 0; c < cols; ++c) {
          float v = std::nearbyint(wr[c] / delta[c]);
          v = std::min((float)hi, std::max((float)lo, v));
          orow[c] = (int8_t)v;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Tensor container: [magic u64][count u64] then per tensor:
//   [name_len u32][name bytes][dtype u32][ndim u32][dims i64 * ndim]
//   [pad to 64][data bytes][pad to 64]
// dtype codes: 0=f32 1=f16 2=bf16 3=i8 4=u8(packed int4) 5=i32
// Readers mmap and slice at recorded offsets (returned by the writer).
// ---------------------------------------------------------------------------

static const uint64_t MAGIC = 0x4d495844515453ULL;  // "MIXDQTS"

int64_t ts_write_header(FILE* f, uint64_t count) {
  if (fwrite(&MAGIC, 8, 1, f) != 1) return -1;
  if (fwrite(&count, 8, 1, f) != 1) return -1;
  return 16;
}

// returns data offset in file, or -1
int64_t ts_write_tensor(FILE* f, const char* name, uint32_t dtype,
                        uint32_t ndim, const int64_t* dims,
                        const void* data, int64_t nbytes) {
  uint32_t name_len = (uint32_t)strlen(name);
  fwrite(&name_len, 4, 1, f);
  fwrite(name, 1, name_len, f);
  fwrite(&dtype, 4, 1, f);
  fwrite(&ndim, 4, 1, f);
  fwrite(dims, 8, ndim, f);
  int64_t pos = ftell(f);
  int64_t aligned = (pos + 63) & ~63LL;
  static const char zeros[64] = {0};
  fwrite(zeros, 1, aligned - pos, f);
  int64_t data_off = ftell(f);
  if (fwrite(data, 1, nbytes, f) != (size_t)nbytes) return -1;
  pos = ftell(f);
  aligned = (pos + 63) & ~63LL;
  fwrite(zeros, 1, aligned - pos, f);
  return data_off;
}

}  // extern "C"
