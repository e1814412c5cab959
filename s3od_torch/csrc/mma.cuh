// Shared tile helpers for the port's mma.sync kernels (K2, K3, K4, K8, K9,
// K10, E1-E4); `hopper.cuh` reuses smem_addr and pack_bf16.
//
// All three kernels use the warp-level `mma.sync.m16n8k16` bf16 product
// with fp32 accumulation, fed from shared memory by `ldmatrix`, and
// `cp.async` 16-byte copies from global memory. Fragment layout of one
// m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, "col"):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16x8, fp32):       c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// Shared-memory tiles keep an 8-element (16-byte) pad per row, which makes
// every ldmatrix phase hit 8 distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3od {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, asynchronous.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i supplies the row address of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// c += a @ b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16x16) of a row-major tile with row stride `ld` elements.
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* tile,
                                            int ld, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of TWO adjacent n8 tiles (16 n x 16 k) from a tile stored
// n-major with k contiguous (an nn.Linear weight, or K in Q @ K^T):
// b[0], b[1] for n-tile 0 and b[2], b[3] for n-tile 1.
__device__ __forceinline__ void load_b_frag_nk(uint32_t b[4], const __nv_bfloat16* tile,
                                               int ld, int lane) {
  ldmatrix_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}

// Same, from a tile stored k-major with n contiguous (V in P @ V).
__device__ __forceinline__ void load_b_frag_kn(uint32_t b[4], const __nv_bfloat16* tile,
                                               int ld, int lane) {
  ldmatrix_x4_trans(b, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace s3od
