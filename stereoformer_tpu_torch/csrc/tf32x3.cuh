// The 3xTF32 warp-level MMA block shared by the conv kernels (sm_90a), and
// the cp.async primitives they stage their tiles with.
//
// A float32 product on the TF32 tensor cores: each float32 operand a is
// split into big = a rounded to TF32 (10 mantissa bits, round to nearest,
// ties away from zero: the bits of cvt.rna.tf32.f32(a)) and small = a - big
// (exact in float32). Then
//     a * b ~ small_a * big_b + big_a * small_b + big_a * big_b,
// which drops small_a * small_b (~2^-22 of |a b|), and each TF32 product is
// exact in float32 (11 x 11 significant bits). The three products run
// as mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in that
// order (CUTLASS's fast-float32 order: the small terms first) into one
// float32 fragment. One TF32 pass alone keeps ~2^-11 of each operand and
// misses a float32 tolerance of 1e-5 by far; three passes hold it.
//
// How: the tensor core reads a .tf32 operand's sign, exponent and top 10
// mantissa bits and ignores the low 13. So big = (bits(a) + 0x1000) with
// the low 13 bits cleared (the rounding of cvt.rna, on the integer pipe,
// which runs four times as fast as cvt's conversion pipe; with cvt the
// conversions, not the MMAs, would bound these kernels), and small is
// passed as it is and read truncated (at most 2^-21 of |a| lost). A NaN whose top
// mantissa bits are all ones rounds to a signed zero in big, but small =
// a - big is then NaN and carries it into the product.
//
// Where the split happens: at fragment load. A warp reads its float32 A and
// B fragments from shared memory and splits them in registers, two integer
// operations and one subtract per element per load. Splitting while staging
// would store big and small in shared memory: twice the bytes staged and
// twice the shared-memory bytes read per MMA, and shared-memory bandwidth
// is already about as busy as the tensor cores in these kernels. The warp
// tiles are made as large as the registers allow, so that each loaded and
// split element feeds several MMAs.
//
// The tensor core's float32 accumulation is not round-to-nearest: it
// truncates each sum toward zero, so a fragment that sums thousands of
// products drifts toward zero by ~2^-24 of its value per MMA. The kernels
// therefore sum one staged tile (a few tens of MMAs) into a fragment that
// starts from zero and add it to a float32 total with ordinary
// round-to-nearest FADDs (`fold`): the long sums stay float32-exact.
//
// Fragment layouts of m16n8k8 with .tf32 (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//     A (16 x 8, row):  a[0] = A[g][t],   a[1] = A[g+8][t],
//                       a[2] = A[g][t+4], a[3] = A[g+8][t+4]
//     B (8 x 8, col):   b[0] = B[t][g],   b[1] = B[t+4][g]
//     C (16 x 8):       c[0] = C[g][2t],  c[1] = C[g][2t+1],
//                       c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
// A caller loads the float32 values at those positions, splits them
// (FragA::set, FragB::set), and calls `mma_tf32x3` on a grid of tiles.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// a ~ big + small: big the TF32 rounding of a (low 13 bits 0), small the
// rest, which the MMA reads truncated to TF32
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// A fragment (4 values) and B fragment (2 values), split
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], big[i], small[i]);
  }
};

struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split(v0, big[0], small[0]);
    split(v1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += A_i B_j in float32 precision for an M x N grid of m16n8
// tiles: small*big, big*small, big*big into each. The passes go over the
// whole grid one after the other, so that M*N independent MMAs separate
// two that accumulate into the same fragment (back to back, each would
// wait for the one before it).
template <int M, int N>
__device__ __forceinline__ void mma_tf32x3(float (&d)[M][N][4],
                                           const FragA (&a)[M],
                                           const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i].small, b[j].big);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i].big, b[j].small);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i].big, b[j].big);
}

// total += part with round-to-nearest adds; part = 0
template <int M, int N>
__device__ __forceinline__ void fold(float (&total)[M][N][4],
                                     float (&part)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        total[i][j][e] += part[i][j][e];
        part[i][j][e] = 0.f;
      }
}

// cp.async: copy `bytes` (16 or 4) to shared memory, of which the first
// src_bytes come from global memory and the rest are zeros (src_bytes 0:
// all zeros, src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// ask), once per kernel and device: no call is made during a later
// CUDA-graph capture. Returns the cudaError_t of the setting (0 when it
// succeeded).
inline int allow_smem(const void* kernel, int bytes) {
  constexpr int kSlots = 64;
  static const void* done_kernel[kSlots] = {};
  static int done_device[kSlots] = {};
  static int ndone = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < ndone; ++i)
    if (done_kernel[i] == kernel && done_device[i] == dev) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (ndone < kSlots) {
    done_kernel[ndone] = kernel;
    done_device[ndone++] = dev;
  }
  return 0;
}

}  // namespace tf32x3
