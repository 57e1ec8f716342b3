// Weight gradient of a stride-1 3x3 SAME convolution on Hopper (sm_90a),
// float32.
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/dw_conv.py::
// conv2d_dw_pallas (body `_kernel`), which the fused conv's backward calls
// (ops/pallas/conv2d.py::_dw). With x [B,H,W,C] and g [B,H,W,Co] NHWC (the
// conv's input and its output's cotangent) and xp the zero-padded x:
//     dw[di,dj,c,co] = sum_{b,h,w} xp[b, h+di, w+dj, c] * g[b,h,w,co]
// written as dw [3,3,C,Co] (HWIO).
//
// What bounds it on the H100: operations. At RAFT's training site with the
// most work (the feature net's layer1, x and g [8,320,720,64]) one call is
// a GEMM [9C x M] x [M x Co] with M = 1.84 M pixels: 136 GFLOP against 944 MB
// read, about 144 flops per byte, far above the card's float32 balance (20
// flops per byte). The output is tiny (9 x 64 x 64), so the whole problem is
// the long reduction over M. The design keeps the FMA pipes fed from
// registers and reads x and g from device memory a few times at most.
//
// Design: split-K over pixels. Block (s, k) takes the s-th of nsplit equal
// runs of 2 x 32 pixel tiles and the k-th chunk of 32 input channels, and
// keeps all 9 taps x 32 channels x Co of dw for them in registers across its
// run. Per tile it stages the 4 x 34 halo tile of x (its 32 channels,
// pixel-major, zeros outside the image) and the 2 x 32 x Co tile of g (zeros
// past the image's edge) in shared memory. A thread owns one tap row di, 4
// input channels and 8 output channels (two float4 runs Co/2 apart, so a
// warp's g loads are contiguous), and all three column taps dj: it walks the
// tile's pixels along each row with a sliding window of three x columns, so
// per pixel it loads one float4 of x and two of g and does 96 FMAs. Each block
// writes its partial dw to a workspace; a second kernel sums the nsplit
// partials of each element in double precision in a fixed order, so the
// result is deterministic and takes no float atomics.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 2;            // pixel rows per tile
constexpr int TW = 32;           // pixel columns per tile
constexpr int KC = 32;           // input channels per block
constexpr int TC = 4;            // input channels per thread (one float4)
constexpr int TN = 8;            // output channels per thread
constexpr int XW = TW + 2;       // halo tile columns
constexpr int XROW = XW * KC;    // floats per halo row, pixel-major
constexpr int CGRP = KC / TC;    // channel groups

template <int CO>
struct Shape {
  static constexpr int COG = CO / TN;          // output channel groups
  static constexpr int NT = 3 * CGRP * COG;    // threads: 192 or 288
  static constexpr int MINB = NT <= 192 ? 2 : 1;
};

template <int CO>
__global__ void __launch_bounds__(Shape<CO>::NT, Shape<CO>::MINB)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ part, int H, int W, int C, int tiles_h,
          int tiles_w, int ntiles) {
  constexpr int NT = Shape<CO>::NT;
  constexpr int COG = Shape<CO>::COG;
  __shared__ __align__(16) float xs[(TH + 2) * XROW];   // [row][col][KC]
  __shared__ __align__(16) float gs[TH * TW * CO];      // [row][col][CO]

  const int split = blockIdx.x;
  const int c0 = blockIdx.y * KC;
  const int cog = threadIdx.x % COG;
  const int cgrp = (threadIdx.x / COG) % CGRP;
  const int di = threadIdx.x / (COG * CGRP);
  const int t_begin = (int)((long long)ntiles * split / gridDim.x);
  const int t_end = (int)((long long)ntiles * (split + 1) / gridDim.x);

  float acc[3][TC][TN];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[j][c][n] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b = tile / (tiles_h * tiles_w);
    const int rem = tile % (tiles_h * tiles_w);
    const int y0 = (rem / tiles_w) * TH;
    const int x0 = (rem % tiles_w) * TW;
    const long long img = (long long)b * H * W;
    __syncthreads();   // the previous tile is consumed
    for (int idx = threadIdx.x; idx < (TH + 2) * XW * (KC / 4); idx += NT) {
      const int q = idx % (KC / 4);
      const int p = idx / (KC / 4);
      const int gy = y0 + p / XW - 1;
      const int gx = x0 + p % XW - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const float4*>(
            x + (img + (long long)gy * W + gx) * C + c0 + 4 * q);
      reinterpret_cast<float4*>(xs)[idx] = v;
    }
    for (int idx = threadIdx.x; idx < TH * TW * CO / 4; idx += NT) {
      const int q = idx % (CO / 4);
      const int p = idx / (CO / 4);
      const int gy = y0 + p / TW;
      const int gx = x0 + p % TW;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy < H && gx < W)
        v = *reinterpret_cast<const float4*>(
            g + (img + (long long)gy * W + gx) * CO + 4 * q);
      reinterpret_cast<float4*>(gs)[idx] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      // output row r reads halo row r + di; column px reads halo columns
      // px, px+1, px+2 for dj = 0, 1, 2
      const float* xr = xs + (r + di) * XROW + cgrp * TC;
      const float* gr = gs + r * TW * CO + cog * 4;
      float4 w0 = *reinterpret_cast<const float4*>(xr);
      float4 w1 = *reinterpret_cast<const float4*>(xr + KC);
#pragma unroll
      for (int px = 0; px < TW; ++px) {
        const float4 w2 = *reinterpret_cast<const float4*>(xr + (px + 2) * KC);
        const float4 ga = *reinterpret_cast<const float4*>(gr + px * CO);
        const float4 gb = *reinterpret_cast<const float4*>(gr + px * CO + CO / 2);
        const float gv[TN] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const float xv[3][TC] = {{w0.x, w0.y, w0.z, w0.w},
                                 {w1.x, w1.y, w1.z, w1.w},
                                 {w2.x, w2.y, w2.z, w2.w}};
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int c = 0; c < TC; ++c)
#pragma unroll
            for (int n = 0; n < TN; ++n)
              acc[j][c][n] = fmaf(xv[j][c], gv[n], acc[j][c][n]);
        w0 = w1;
        w1 = w2;
      }
    }
  }

  // the block's partial: part[split][di*3 + dj][c0 + cgrp*TC + c][co]
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      float* dst = part + (((long long)split * 9 + di * 3 + j) * C + c0 +
                           cgrp * TC + c) * CO + cog * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[j][c][0], acc[j][c][1], acc[j][c][2], acc[j][c][3]);
      *reinterpret_cast<float4*>(dst + CO / 2) =
          make_float4(acc[j][c][4], acc[j][c][5], acc[j][c][6], acc[j][c][7]);
    }
  }
}

// dw[i] = sum over the nsplit partials part[s][i], in double, s in order.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int n, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double sum = 0.0;
  for (int s = 0; s < nsplit; ++s) sum += (double)part[(long long)s * n + i];
  dw[i] = (float)sum;
}

template <int CO>
int launch(const float* x, const float* g, float* part, float* dw, int B,
           int H, int W, int C, int nsplit, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dw_kernel<CO><<<dim3(nsplit, C / KC), Shape<CO>::NT, 0, stream>>>(
      x, g, part, H, W, C, tiles_h, tiles_w, (int)ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * CO;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C], g [B,H,W,Co], dw [3,3,C,Co]: float32, contiguous, 16-byte
// aligned; part: scratch of nsplit * 9 * C * Co floats. C a multiple of 32,
// Co 64 or 96 (RAFT's routed sites); nsplit >= 1 blocks share the pixels of
// each channel chunk.
// Returns cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int conv2d_dw(const float* x, const float* g, float* part,
                         float* dw, int B, int H, int W, int C, int Co,
                         int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % KC || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Co) {
    case 64: return launch<64>(x, g, part, dw, B, H, W, C, nsplit, st);
    case 96: return launch<96>(x, g, part, dw, B, H, W, C, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
