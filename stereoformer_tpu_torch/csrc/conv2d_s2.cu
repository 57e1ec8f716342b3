// Fused stride-2 3x3 SAME convolution on Hopper (sm_90a), float32.
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/conv2d.py::_forward_s2
// (body `_kernel_s2`, public `conv2d_fused_s2`). With x [B,H,W,C] NHWC (H and
// W even), w [3,3,C,Co] HWIO, b [Co] and y [B,H/2,W/2,Co] NHWC:
//     y[b,i,j,o] = relu?(b[o] + sum_{ky,kx,c} x[b, 2i+ky-1, 2j+kx-1, c]
//                                             * w[ky,kx,c,o])
// with taps outside the image reading 0 (padding 1 on every side).
//
// What bounds it on the H100: operations. At RAFT's first stride-2 site
// ([4,576,960,64] -> 96) one call is 61 GFLOP against 0.78 GB moved, about
// 78 flops per byte, above the card's float32 balance (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte). So, as in the stride-1 kernel
// (conv2d_fused.cu), the FMA pipes are fed from registers and shared memory.
//
// Design: an implicit GEMM in float32 FMA. The Pallas kernel splits x into
// four row/column phases outside the kernel and packs the taps into four
// phase matmuls, because Mosaic cannot read strided rows or columns from
// VMEM. A GPU can: a block stages the (2*8+1) x (2*32+1) input window of an
// 8 x 32 output tile, 8 input channels at a time, in shared memory, and
// each thread reads its taps with plain indexed loads. The window's even
// and odd columns are stored apart, so that the 32 lanes (one output column
// each) read 32 consecutive words for every tap and hit no bank twice. A
// block computes 32 output channels (blockIdx.x walks Co in slices of 32,
// fastest, so the blocks that share a window run together and find it in
// L2); a warp owns 16 of them for 4 output rows, with its 64 sums in
// registers. Per input channel a thread reads its 9 x 3 window values once
// and each tap's weight row as broadcast float4s, then does 576 FMAs. Input
// channels past C and output channels past Co are staged as zeros, so any C
// and Co work. Bias and ReLU fuse into the epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;               // output rows per block
constexpr int TW = 32;              // output columns per block (one per lane)
constexpr int RPT = 4;              // output rows per thread
constexpr int RG = TH / RPT;        // row groups per block
constexpr int TN = 16;              // output channels per thread (per warp)
constexpr int CB = 32;              // output channels per block
constexpr int CG = CB / TN;         // channel groups per block
constexpr int NT = CG * RG * 32;    // threads per block
constexpr int KC = 8;               // input channels per staged chunk
constexpr int IH = 2 * TH + 1;      // window rows
constexpr int IWE = TW + 1;         // window columns 0, 2, ..., 2*TW
constexpr int IROW = IWE + TW;      // then columns 1, 3, ..., 2*TW-1
constexpr int IPLANE = IH * IROW;   // one channel of the window

// The position of window column q in a staged row: even columns first.
__device__ __forceinline__ int col_pos(int q) {
  return (q & 1) ? IWE + (q >> 1) : (q >> 1);
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 3)
conv3x3_s2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int H, int W, int C, int Ho, int Wo, int Co, int tiles_w,
                  int relu) {
  __shared__ __align__(16) float xs[KC * IPLANE];   // [KC][IH][IROW]
  __shared__ __align__(16) float ws[9 * KC * CB];   // [tap][KC][CB]

  const int cb0 = blockIdx.x * CB;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int gy0 = 2 * oy0 - 1;      // the window's first input row
  const int gx0 = 2 * ox0 - 1;      // and column
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = warp % CG;
  const int r0 = (warp / CG) * RPT;
  const int co0 = cb0 + cg * TN;
  const long long img = (long long)b * H * W;

  float acc[RPT][TN];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();   // the previous chunk is consumed
    if (VEC) {
      // C % 4 == 0: four channels of one pixel per load
      for (int idx = threadIdx.x; idx < IH * IROW * (KC / 4); idx += NT) {
        const int q4 = idx % (KC / 4);
        const int p = idx / (KC / 4);
        const int r = p / IROW, q = p % IROW;
        const int gy = gy0 + r, gx = gx0 + q, c = c0 + 4 * q4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
          v = *reinterpret_cast<const float4*>(
              x + ((img + (long long)gy * W + gx) * C + c));
        float* dst = xs + 4 * q4 * IPLANE + r * IROW + col_pos(q);
        dst[0] = v.x;
        dst[IPLANE] = v.y;
        dst[2 * IPLANE] = v.z;
        dst[3 * IPLANE] = v.w;
      }
    } else {
      for (int idx = threadIdx.x; idx < IH * IROW * KC; idx += NT) {
        const int cc = idx % KC;
        const int p = idx / KC;
        const int r = p / IROW, q = p % IROW;
        const int gy = gy0 + r, gx = gx0 + q, c = c0 + cc;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
          v = x[(img + (long long)gy * W + gx) * C + c];
        xs[cc * IPLANE + r * IROW + col_pos(q)] = v;
      }
    }
    // the chunk's weights for this block's output channels, zero past C, Co
    for (int idx = threadIdx.x; idx < 9 * KC * CB; idx += NT) {
      const int n = idx % CB;
      const int cc = (idx / CB) % KC;
      const int tap = idx / (CB * KC);
      const int c = c0 + cc, o = cb0 + n;
      ws[idx] = (c < C && o < Co) ? w[((long long)tap * C + c) * Co + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
      // window rows 2*r0 .. 2*r0 + 2*RPT; columns 2*lane + kx
      const float* xr = xs + c * IPLANE + 2 * r0 * IROW;
      float in[2 * RPT + 1][3];
#pragma unroll
      for (int i = 0; i < 2 * RPT + 1; ++i) {
        in[i][0] = xr[i * IROW + lane];
        in[i][1] = xr[i * IROW + IWE + lane];
        in[i][2] = xr[i * IROW + lane + 1];
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wr = reinterpret_cast<const float4*>(
              ws + ((ky * 3 + kx) * KC + c) * CB + cg * TN);
          float wv[TN];
#pragma unroll
          for (int n4 = 0; n4 < TN / 4; ++n4) {
            const float4 q = wr[n4];
            wv[4 * n4] = q.x;
            wv[4 * n4 + 1] = q.y;
            wv[4 * n4 + 2] = q.z;
            wv[4 * n4 + 3] = q.w;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float a = in[2 * i + ky][kx];
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a, wv[n], acc[i][n]);
          }
        }
      }
    }
  }

  // epilogue: bias, ReLU, store the channels below Co
  if (co0 >= Co) return;
  const int nco = min(TN, Co - co0);
  float bv[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) bv[n] = n < nco ? bias[co0 + n] : 0.f;
  const int ox = ox0 + lane;
  const bool vec_out = nco == TN && Co % 4 == 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int oy = oy0 + r0 + i;
    if (oy >= Ho || ox >= Wo) continue;
    float* o = y + (((long long)b * Ho + oy) * Wo + ox) * Co + co0;
    float v[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      v[n] = acc[i][n] + bv[n];
      if (relu) v[n] = fmaxf(v[n], 0.f);
    }
    if (vec_out) {
#pragma unroll
      for (int n4 = 0; n4 < TN / 4; ++n4)
        reinterpret_cast<float4*>(o)[n4] =
            make_float4(v[4 * n4], v[4 * n4 + 1], v[4 * n4 + 2], v[4 * n4 + 3]);
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if (n < nco) o[n] = v[n];
    }
  }
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias [Co], y [B,H/2,W/2,Co]: float32,
// contiguous, 16-byte aligned; H and W even; any C and Co.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int conv2d_s2_forward(const float* x, const float* w,
                                 const float* bias, float* y, int B, int H,
                                 int W, int C, int Co, int relu,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = (Wo + TW - 1) / TW;
  const long long tiles = (long long)((Ho + TH - 1) / TH) * tiles_w;
  if (tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Co + CB - 1) / CB, (unsigned)tiles, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0)
    conv3x3_s2_kernel<true><<<grid, NT, 0, s>>>(x, w, bias, y, H, W, C, Ho,
                                                Wo, Co, tiles_w, relu);
  else
    conv3x3_s2_kernel<false><<<grid, NT, 0, s>>>(x, w, bias, y, H, W, C, Ho,
                                                 Wo, Co, tiles_w, relu);
  return (int)cudaGetLastError();
}
