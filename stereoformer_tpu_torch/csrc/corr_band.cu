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
// Design: one block per (b, h, tile of TW = 32 pixels along W, span of up
// to 32 disparities); the spans of a large D are further blocks, so
// neither the block nor its shared memory grows with D. Warp g of the block
// owns 8 disparities of the span; its lane (i, k) = (lane % 8, lane / 8)
// owns pixels 4i .. 4i+3 of the tile and the channel quads q = k, k+4, ...
// of each staged chunk, so each thread keeps 4 x 8 partial sums in
// registers and the four lanes k of a pixel group split the channels. Per
// channel quad a thread reads 4 L rows and the 11 R rows its 32 outputs
// need, as 16-byte loads from shared memory. Channels are staged CK = 32 at
// a time, NST = 4 stages deep: cp.async copies chunk k + 3 of the L tile
// [TW, CK] and the R slab [TW + span - 1, CK] (rows outside the image are
// zero-filled, which also makes every w < d output exactly 0) while the
// block computes on chunk k. Each 128-byte row keeps its eight 16-byte
// chunks in an order XOR-ed with (row / 4) % 8, so the 8 lanes of a
// quarter-warp (one k, rows 4 apart) read 8 different chunks: no bank
// conflicts, no padding. At the end the four lanes k of a pixel group sum
// their partials by two XOR shuffles in a fixed order, each keeping one
// pixel, and write its 8 consecutive outputs as two 16-byte stores.
//
// The bf16 form (corr_band_forward_bf16): L, R and the volume bf16, as
// ops/cost_volume.py::correlation_volume_matmul computes them in bf16: the
// products (exact in float32) summed in float32, divided by C, rounded to
// bf16 once on the store. The same kernel, templated on the element: a
// staged row is still 128 bytes, now 64 channels, its eight 16-byte chunks
// of 8 channels each in the same swizzled order; a thread widens a chunk to
// float32 (a bf16 is the top half of its float32) in two passes of 4
// channels, the even and the odd ones, and runs the float32 FMAs; one
// 16-byte store writes a lane's 8 outputs. Half the bytes of the float32
// form in and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WT = 4;           // pixels per thread
constexpr int KS = 4;           // lanes that split a pixel group's channels
constexpr int TW = 32 / KS * WT;   // pixels per block: 32
constexpr int DT = 8;           // disparities per warp
constexpr int NW = 4;           // most warps per block
constexpr int CK = 32;          // floats per staged row: 128 bytes
constexpr int NST = 4;          // stages
constexpr unsigned FULL = 0xffffffffu;

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

// float offset of 16-byte chunk q (4 float32 or 8 bf16 channels) of
// staged row r
__device__ __forceinline__ int slot(int r, int q) {
  return r * CK + ((q ^ ((r >> 2) & 7)) << 2);
}

// floats of one stage for a span of `span` disparities: L tile, R slab
__host__ __device__ inline int stage_floats(int span) {
  return (TW + TW + span - 1) * CK;
}

// the float32 values of 16 bytes of T: 4 floats, or for bf16 the even
// (half 0) or odd (half 1) channels of 8
template <typename T>
__device__ __forceinline__ float4 widen(float4 v, int half) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    const unsigned m = half ? 0xffff0000u : 0x0000ffffu;
    const int sh = half ? 0 : 16;
    return make_float4(__uint_as_float((__float_as_uint(v.x) & m) << sh),
                       __uint_as_float((__float_as_uint(v.y) & m) << sh),
                       __uint_as_float((__float_as_uint(v.z) & m) << sh),
                       __uint_as_float((__float_as_uint(v.w) & m) << sh));
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * NW)
corr_band_kernel(const T* __restrict__ left, const T* __restrict__ right,
                 T* __restrict__ out, int W, int C, int D, int tiles) {
  constexpr int CPQ = 16 / (int)sizeof(T);   // channels per 16-byte chunk
  constexpr int CKT = CK / 4 * CPQ;           // channels per stage
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (blockDim.x >> 5) * DT;   // disparities of the block
  const int rlen = TW + span - 1;            // R slab rows
  const int stage = stage_floats(span);

  const int w0 = (blockIdx.x % tiles) * TW;
  const int dspan = (blockIdx.x / tiles) * span;   // the span's first d
  const long long row = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * W;
  const T* lrow = left + row * C;
  const T* rrow = right + row * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, i = lane & 7, k = lane >> 3;
  const int dw = (tid >> 5) * DT;            // the warp's first d in the span
  const int nchunks = (C + CKT - 1) / CKT;
  // R slab row 0 is pixel w0 - dspan - (span - 1)
  const int rbase = w0 - dspan - (span - 1);

  auto load = [&](int c0) {
    float* ls = smem + ((c0 / CKT) % NST) * stage;
    for (int n = tid; n < (TW + rlen) * (CK / 4); n += blockDim.x) {
      const int r = n / (CK / 4), q = n % (CK / 4);
      const bool is_l = r < TW;
      const int rr = is_l ? r : r - TW;
      const int w = is_l ? w0 + rr : rbase + rr;
      const int c = c0 + CPQ * q;
      const bool ok = w >= 0 && w < W && c < C;
      const T* base = is_l ? lrow : rrow;
      cp_async16(ls + (is_l ? 0 : TW * CK) + slot(rr, q),
                 ok ? base + (long long)w * C + c : base, ok ? 16 : 0);
    }
  };

  float acc[WT][DT];
#pragma unroll
  for (int a = 0; a < WT; ++a)
#pragma unroll
    for (int b = 0; b < DT; ++b) acc[a][b] = 0.f;

  // R row of output (pixel 4i + a, disparity dspan + dw + b) in the slab:
  // 4i + a - dw - b + span - 1 = j0 + a - b + DT - 1, within [0, rlen)
  const int j0 = WT * i + span - 1 - dw - (DT - 1);
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nchunks) load(s * CKT);
    cp_async_commit();
  }
  for (int k0 = 0; k0 < nchunks; ++k0) {
    cp_async_wait<NST - 2>();   // chunk k0 has landed
    __syncthreads();            // ... for every thread; chunk k0 - 1 is done
    if (k0 + NST - 1 < nchunks) load((k0 + NST - 1) * CKT);
    cp_async_commit();
    const float* ls = smem + (k0 % NST) * stage;
    const float* rs = ls + TW * CK;
#pragma unroll
    for (int qk = 0; qk < CK / 4 / KS; ++qk) {
      const int q = k + KS * qk;
      float4 l[WT], r[WT + DT - 1];
#pragma unroll
      for (int a = 0; a < WT; ++a)
        l[a] = *reinterpret_cast<const float4*>(ls + slot(WT * i + a, q));
#pragma unroll
      for (int t = 0; t < WT + DT - 1; ++t)
        r[t] = *reinterpret_cast<const float4*>(rs + slot(j0 + t, q));
#pragma unroll
      for (int half = 0; half < (int)(4 / sizeof(T)); ++half)
#pragma unroll
        for (int a = 0; a < WT; ++a)
#pragma unroll
          for (int b = 0; b < DT; ++b) {
            const float4 x = widen<T>(l[a], half);
            const float4 y = widen<T>(r[a - b + DT - 1], half);
            float s = acc[a][b];
            s = fmaf(x.x, y.x, s);
            s = fmaf(x.y, y.y, s);
            s = fmaf(x.z, y.z, s);
            s = fmaf(x.w, y.w, s);
            acc[a][b] = s;
          }
    }
  }

  // sum the four lanes k of a pixel group; lane k keeps pixel 4i + k:
  // first over k's bit 1 (pixels {0,1} or {2,3} kept), then over bit 0
  const bool hi = k & 2, lo = k & 1;
  float part[2][DT], res[DT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < DT; ++b) {
      const float send = hi ? acc[a][b] : acc[a + 2][b];
      const float keep = hi ? acc[a + 2][b] : acc[a][b];
      part[a][b] = keep + __shfl_xor_sync(FULL, send, 16);
    }
#pragma unroll
  for (int b = 0; b < DT; ++b) {
    const float send = lo ? part[0][b] : part[1][b];
    const float keep = lo ? part[1][b] : part[0][b];
    res[b] = keep + __shfl_xor_sync(FULL, send, 8);
  }

  const int w = w0 + WT * i + k;
  const int d0 = dspan + dw;
  if (w >= W || d0 >= D) return;
  const float fc = (float)C;
  T* o = out + (row + w) * D + d0;
  if constexpr (sizeof(T) == 4) {
    if (d0 + DT <= D && (D & 3) == 0) {
      reinterpret_cast<float4*>(o)[0] =
          make_float4(res[0] / fc, res[1] / fc, res[2] / fc, res[3] / fc);
      reinterpret_cast<float4*>(o)[1] =
          make_float4(res[4] / fc, res[5] / fc, res[6] / fc, res[7] / fc);
      return;
    }
  } else {
    if (d0 + DT <= D && (D & 7) == 0) {
      __nv_bfloat162 v[DT / 2];
#pragma unroll
      for (int b = 0; b < DT / 2; ++b)
        v[b] = __floats2bfloat162_rn(res[2 * b] / fc, res[2 * b + 1] / fc);
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < DT; ++b)
    if (d0 + b < D) o[b] = (T)(res[b] / fc);
}

template <typename T>
int launch(const T* left, const T* right, T* out, int B, int H, int W,
           int C, int D, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % (16 / sizeof(T)) != 0 ||
      D <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int warps = min(NW, (D + DT - 1) / DT);
  const int span = warps * DT;
  const long long tiles = (W + TW - 1) / TW;
  const long long blocks = tiles * ((D + span - 1) / span);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NST * stage_floats(span) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_band_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks, H, B);
  corr_band_kernel<T><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      left, right, out, W, C, D, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// left, right: float32 [B, H, W, C] contiguous, C a multiple of 4, 16-byte
// aligned; out: float32 [B, H, W, D] contiguous; stream: a cudaStream_t.
// Returns the error of the shared-memory setting or cudaGetLastError() after
// the launch (0 when it was accepted).
extern "C" int corr_band_forward(const float* left, const float* right,
                                 float* out, int B, int H, int W, int C,
                                 int D, void* stream) {
  return launch(left, right, out, B, H, W, C, D, stream);
}

// The bf16 form: left, right bf16 [B, H, W, C], C a multiple of 8, 16-byte
// aligned; out bf16 [B, H, W, D]; otherwise as corr_band_forward.
extern "C" int corr_band_forward_bf16(const void* left, const void* right,
                                      void* out, int B, int H, int W, int C,
                                      int D, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch(static_cast<const bf16*>(left),
                static_cast<const bf16*>(right), static_cast<bf16*>(out), B,
                H, W, C, D, stream);
}
