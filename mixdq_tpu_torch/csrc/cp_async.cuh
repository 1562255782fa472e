// Asynchronous global -> shared copies and ldmatrix fragment loads, shared
// by the pipelined kernels (the attention kernels' key ring, wq_matmul.cu).
//
// A ring of S stages in shared memory is filled by cp.async.cg 16-byte
// copies, one commit group per stage: before consuming stage i a thread
// waits until at most S - 2 of its groups are pending, then the block
// synchronises, so the copies of stages i + 1 .. i + S - 2 stay in flight
// while stage i is computed on.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mixdq {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared address `dst` (smem_addr); with
// `valid` false the 16 bytes are zero-filled and nothing is read (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 16 bytes that other blocks of the SM read too (cp.async.ca: cached in
// L1 on the way, so that their copies hit it).
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// 8 bytes, zero-filled where not `valid` (cp.async.ca: the .cg form
// takes 16 only).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}

// 4 bytes, the same way (cp.async.ca: the .cg form takes 16 only).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared address a (smem_addr); lane l gives
// the row address of matrix l / 8.
// Thread T gets row T / 4, columns 2 (T % 4) and 2 (T % 4) + 1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, transposed: thread T gets rows 2 (T % 4), 2 (T % 4) + 1 of
// column T / 4 (an mma B fragment from a k-major tile).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

}  // namespace mixdq
