// Banded correlation volume on Hopper (sm_90a).
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/corr_band.py::_forward
// (body `_kernel`). For NHWC features L, R [B, H, W, C] it writes the volume
// [B, H, W, D] with
//     out[b,h,w,d] = (1/C) * sum_c L[b,h,w,c] * R[b,h,w-d,c],   0 where w < d,
// without forming the W x W similarity matrix that the TPU kernel builds on
// its matrix unit.
//
// What bounds it on the H100: memory. It must read L and R once
// (2*B*H*W*C*4 bytes) and write the volume once (B*H*W*D*4 bytes); at the
// main path's C = 256, D = 24 that is ~21 bytes moved per multiply-add, far
// below the card's float32 rate, so the kernel is bytes-bound.
//
// Design: one block per (b, h, tile of TW = 128 pixels along W); warp g
// owns disparities 8g .. 8g+7 and lane l the pixels 4l .. 4l+3 of the tile,
// so each thread keeps 4 x 8 sums in registers. Per group of 4 channels a
// thread reads 4 L rows and the 11 R rows those 32 outputs need, as 16-byte
// loads from shared memory: 15 loads for 128 multiply-adds, where one
// output per thread would need 9 loads for 8. Channels are staged CK = 32
// at a time, two stages deep: cp.async copies the next chunk of the L tile
// [TW, CK] and the R slab [TW + D - 1, CK] (pixels w0-D+1 .. w0+TW-1; rows
// outside the image are zero-filled, which also makes every w < d output
// exactly 0) while the block computes on the current one. Each 128-byte row
// keeps its eight 16-byte chunks in an order XOR-ed with (row / 4) % 8, so
// the 8 lanes of a quarter-warp, 4 rows apart, read 8 different chunks: no
// bank conflicts, no padding. The outputs of a thread's pixel are 8
// consecutive floats of the volume, written as two 16-byte stores.

#include <cuda_runtime.h>

namespace {

constexpr int WT = 4;          // pixels per thread
constexpr int TW = 32 * WT;    // pixels per block
constexpr int DT = 8;          // disparities per thread (per warp)
constexpr int CK = 32;         // channels per stage: one 128-byte row
constexpr int D_MAX = 64;      // 8 warps: the block's thread bound below

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// float offset of channel chunk q (4 channels) of staged row r
__device__ __forceinline__ int slot(int r, int q) {
  return r * CK + ((q ^ ((r >> 2) & 7)) << 2);
}

__global__ void __launch_bounds__(32 * (D_MAX / DT))
corr_band_kernel(const float* __restrict__ left,
                 const float* __restrict__ right, float* __restrict__ out,
                 int W, int C, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rlen = TW + D - 1;             // R slab rows
  const int stage = (TW + rlen) * CK;      // floats per stage: L tile, R slab

  const int w0 = blockIdx.x * TW;
  const long long row = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * W;
  const float* lrow = left + row * C;
  const float* rrow = right + row * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int d0 = (tid >> 5) * DT;
  const int nchunks = (C + CK - 1) / CK;

  auto load = [&](int s, int c0) {
    float* ls = smem + s * stage;
    for (int i = tid; i < (TW + rlen) * (CK / 4); i += blockDim.x) {
      const int r = i / (CK / 4), q = i % (CK / 4);
      const bool is_l = r < TW;
      const int rr = is_l ? r : r - TW;
      const int w = is_l ? w0 + rr : w0 - (D - 1) + rr;
      const int c = c0 + 4 * q;
      const bool ok = w >= 0 && w < W && c < C;
      const float* base = is_l ? lrow : rrow;
      cp_async16(ls + (is_l ? 0 : TW * CK) + slot(rr, q),
                 ok ? base + (long long)w * C + c : base, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[WT][DT];
#pragma unroll
  for (int i = 0; i < WT; ++i)
#pragma unroll
    for (int k = 0; k < DT; ++k) acc[i][k] = 0.f;

  // R row of output (pixel 4*lane + i, disparity d0 + k) in the slab:
  // j0 + i - k + DT - 1. For the last warp's d >= D (when DT does not
  // divide D) rows reach at most DT - 1 below the slab, into the L tile:
  // still shared memory, and those sums are never stored.
  const int j0 = WT * lane + D - 1 - d0 - (DT - 1);
  load(0, 0);
  for (int k0 = 0; k0 < nchunks; ++k0) {
    if (k0 + 1 < nchunks) {
      load((k0 + 1) & 1, (k0 + 1) * CK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ls = smem + (k0 & 1) * stage;
    const float* rs = ls + TW * CK;
#pragma unroll 2
    for (int q = 0; q < CK / 4; ++q) {
      float4 l[WT], r[WT + DT - 1];
#pragma unroll
      for (int i = 0; i < WT; ++i)
        l[i] = *reinterpret_cast<const float4*>(ls + slot(WT * lane + i, q));
#pragma unroll
      for (int t = 0; t < WT + DT - 1; ++t)
        r[t] = *reinterpret_cast<const float4*>(rs + slot(j0 + t, q));
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int k = 0; k < DT; ++k) {
          const float4 a = l[i], b = r[i - k + DT - 1];
          float s = acc[i][k];
          s = fmaf(a.x, b.x, s);
          s = fmaf(a.y, b.y, s);
          s = fmaf(a.z, b.z, s);
          s = fmaf(a.w, b.w, s);
          acc[i][k] = s;
        }
    }
    __syncthreads();   // the next load overwrites this stage
  }

  const float fc = (float)C;
#pragma unroll
  for (int i = 0; i < WT; ++i) {
    const int w = w0 + WT * lane + i;
    if (w >= W) continue;
    float* o = out + (row + w) * D + d0;
    if (d0 + DT <= D && (D & 3) == 0) {
      reinterpret_cast<float4*>(o)[0] =
          make_float4(acc[i][0] / fc, acc[i][1] / fc,
                      acc[i][2] / fc, acc[i][3] / fc);
      reinterpret_cast<float4*>(o)[1] =
          make_float4(acc[i][4] / fc, acc[i][5] / fc,
                      acc[i][6] / fc, acc[i][7] / fc);
    } else {
#pragma unroll
      for (int k = 0; k < DT; ++k)
        if (d0 + k < D) o[k] = acc[i][k] / fc;
    }
  }
}

}  // namespace

// left, right: float32 [B, H, W, C] contiguous, C a multiple of 4, 16-byte
// aligned; out: float32 [B, H, W, D] contiguous; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int corr_band_forward(const float* left, const float* right,
                                 float* out, int B, int H, int W, int C,
                                 int D, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 != 0 || D <= 0 ||
      D > D_MAX || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int groups = (D + DT - 1) / DT;
  const size_t smem = 2 * (size_t)(2 * TW + D - 1) * CK * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, H, B);
  corr_band_kernel<<<grid, 32 * groups, smem, (cudaStream_t)stream>>>(
      left, right, out, W, C, D);
  return (int)cudaGetLastError();
}
