// Small int8 building blocks shared by the int8 GEMM mainloop
// (igemm_s8.cuh) and the attention kernels (attn_mma.cuh,
// int8_flash.cu): a 16-byte chunk of codes, the int8 mma.sync
// m16n8k32 (s8 x s8 -> s32), and the alignment test of the 16-byte
// copies.
#pragma once

#include "common.cuh"

namespace mixdq {

union Chunk16 {
  int4 v;
  int8_t s[16];
};

__device__ __forceinline__ Chunk16 fill16(int8_t b) {
  const int w = static_cast<int>(static_cast<uint8_t>(b)) * 0x01010101;
  Chunk16 u;
  u.v = make_int4(w, w, w, w);
  return u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte vector loads need the row stride and the base address aligned.
inline bool vec16(const void* p, int ld) {
  return ld % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mixdq
