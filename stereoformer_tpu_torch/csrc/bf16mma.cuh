// bf16 tensor-core building blocks shared by the bf16 forms of
// conv2d_fused.cu and conv2d_dw.cu: ldmatrix from shared memory and
// mma.sync m16n8k16 with bf16 operands and float32 accumulators. A
// bf16 x bf16 product is exact in float32, so the operands need no split
// (tf32x3.cuh); the accumulators' adds still truncate (tf32x3.cuh says by
// how much), so a kernel that sums thousands of MMAs folds them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bf16mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the four 8x8 bf16 matrices whose rows lane i gives, rows i of matrix i/8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed: lane t of a matrix whose rows are
// given holds elements [2 (t % 4)][t / 4] and [2 (t % 4) + 1][t / 4]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the first two of those (matrices whose rows lanes 0-15 give), transposed
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// d += A B for one m16n8k16 tile, bf16 operands, float32 accumulators.
// Fragments (PTX ISA, "mma.m16n8k16" for .bf16), g = lane / 4, t = lane % 4:
//     a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//     a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9]
//     b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
// and d as the m16n8k8 C fragment (tf32x3.cuh).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma
