// Fused stride-2 3x3 SAME convolution on Hopper (sm_90a), float32 by 3xTF32
// on the tensor cores.
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
// 78 flops per byte: 0.91 ms in float32 FMA at 67 TFLOP/s, 0.37 ms on the
// TF32 tensor cores with three products per float32 product (tf32x3.cuh).
//
// Design: the forward implicit GEMM Y[pix, Co] = Xcol[pix, 9C] W[9C, Co] on
// mma.sync m16n8k8 in 3xTF32. The Pallas kernel splits x into four
// row/column phases outside the kernel and packs the taps into four phase
// matmuls, because Mosaic cannot read strided rows or columns from VMEM. A
// GPU can: a block takes 4 x 32 output pixels and 32 output channels
// (at each of RAFT's six stride-2 sites at least 144 blocks for the 132
// SMs), and walks C in chunks of 8. Per chunk it stages, double-buffered
// with cp.async, the 9 x 65 input window of its pixels and the chunk's
// 9 x 8 x 32 weights. The window's even and odd columns are stored apart
// (col_pos), so a tap's 16 consecutive output columns read 16 consecutive
// window pixels; each pixel holds its 8 channels, the two float4 halves
// swapped on every other 4-pixel group, so the A-fragment loads (8 pixels
// x 4 channels a warp) hit 32 banks. A warp owns one output row: two m16 tiles (32 columns) x four
// n8 tiles (32 channels). A k-step is one tap's 8 channels: the A fragment
// is the window at that tap, the B fragment its weights, split to big and
// small at load and multiplied three times (mma_tf32x3). A chunk's 9
// k-steps sum into fragments from zero, which are then added to float32
// totals (tf32x3.cuh, `fold`). Channels past C and past Co are staged as
// zeros, so any C and Co work. Bias and ReLU fuse into the epilogue.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int TH = 4;               // output rows per block
constexpr int TW = 32;              // output columns per block
constexpr int CB = 32;              // output channels per block
constexpr int KC = 8;               // input channels per staged chunk
constexpr int IWE = TW + 1;         // window columns 0, 2, ..., 2*TW
constexpr int IROW = IWE + TW;      // then columns 1, 3, ..., 2*TW-1
constexpr int WS = CB + 8;          // floats per staged weight row
constexpr int WST = 9 * KC * WS;    // floats of one chunk's weights
constexpr int IH = 2 * TH + 1;      // window rows
constexpr int NP = IH * IROW;       // window pixels
constexpr int XST = NP * KC;        // floats of one staged window
constexpr int STAGE = XST + WST;    // floats of one stage
// two stages, then the window's pixel offsets (`offsets`)
constexpr int SMEM = (2 * STAGE + NP) * (int)sizeof(float);
constexpr int NT = 32 * TH;         // one warp per output row
// resident blocks per SM: 12 warps (registers allow no more)
constexpr int MINB = 3;

// The position of window column q in a staged row: even columns first.
__device__ __forceinline__ int col_pos(int q) {
  return (q & 1) ? IWE + (q >> 1) : (q >> 1);
}

// the float offset of channel quad q4 (0 or 1) of window pixel p: the two
// quads swap on every other group of 4 pixels
__device__ __forceinline__ int xq(int p, int q4) {
  return p * KC + ((q4 ^ ((p >> 2) & 1)) << 2);
}

// offsets[p]: where window pixel p starts in the image xb (its row times
// W plus its column, times C), or -1 outside the image; the same for every
// channel chunk, so computed once per block
__device__ __forceinline__ void window_offsets(int* offsets, int gy0,
                                               int gx0, int H, int W, int C) {
  for (int p = threadIdx.x; p < NP; p += NT) {
    const int pos = p % IROW;
    const int gy = gy0 + p / IROW;
    const int gx = gx0 + (pos < IWE ? 2 * pos : 2 * (pos - IWE) + 1);
    offsets[p] =
        gy >= 0 && gy < H && gx >= 0 && gx < W ? (gy * W + gx) * C : -1;
  }
}

template <bool VEC>
__device__ __forceinline__ void stage(const float* __restrict__ xb,
                                      const float* __restrict__ w,
                                      const int* offsets, float* xs,
                                      float* ws, int c0, int cb0, int C,
                                      int Co) {
  if (VEC) {
    // C % 4 == 0 and Co % 4 == 0: 16-byte pieces; NT is even, so a thread
    // keeps its channel quad
    const int q4 = threadIdx.x & 1, c = c0 + 4 * q4;
    for (int p = threadIdx.x >> 1; p < NP; p += NT / 2) {
      const int off = offsets[p];
      const bool ok = off >= 0 && c < C;
      tf32x3::cp_async16(xs + xq(p, q4), ok ? xb + off + c : xb,
                         ok ? 16 : 0);
    }
    for (int idx = threadIdx.x; idx < 9 * KC * (CB / 4); idx += NT) {
      const int n4 = idx % (CB / 4);
      const int row = idx / (CB / 4);   // tap * KC + kk
      const int c = c0 + row % KC, o = cb0 + 4 * n4;
      const bool ok = c < C && o < Co;
      const float* src =
          ok ? w + ((long long)(row / KC) * C + c) * Co + o : w;
      tf32x3::cp_async16(ws + row * WS + 4 * n4, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < NP * KC; idx += NT) {
      const int cc = idx % KC;
      const int p = idx / KC;
      const int off = offsets[p], c = c0 + cc;
      const bool ok = off >= 0 && c < C;
      tf32x3::cp_async4(xs + xq(p, cc >> 2) + (cc & 3),
                        ok ? xb + off + c : xb, ok ? 4 : 0);
    }
    for (int idx = threadIdx.x; idx < 9 * KC * CB; idx += NT) {
      const int n = idx % CB;
      const int row = idx / CB;
      const int c = c0 + row % KC, o = cb0 + n;
      const bool ok = c < C && o < Co;
      const float* src =
          ok ? w + ((long long)(row / KC) * C + c) * Co + o : w;
      tf32x3::cp_async4(ws + row * WS + n, src, ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, MINB)
conv3x3_s2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int H, int W, int C, int Ho, int Wo, int Co, int tiles_w,
                  int relu) {
  // 2 x [window, weights], then the window's pixel offsets
  extern __shared__ __align__(16) float smem[];

  const int cb0 = blockIdx.x * CB;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int gy0 = 2 * oy0 - 1;      // the window's first input row
  const int gx0 = 2 * ox0 - 1;      // and column
  const long long img = (long long)b * H * W;
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;   // the warp's output row in the tile
  const int gid = lane >> 2, tig = lane & 3;

  // [n8 tile pair jp][m16 tile h][tile jj of the pair]: n8 tile 2 jp + jj
  float acc[2][2][2][4], tot[2][2][2][4];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jp][h][jj][e] = tot[jp][h][jj][e] = 0.f;

  const float* xb = x + img * C;
  int* offsets = reinterpret_cast<int*>(smem + 2 * STAGE);
  window_offsets(offsets, gy0, gx0, H, W, C);
  __syncthreads();
  stage<VEC>(xb, w, offsets, smem, smem + XST, 0, cb0, C, Co);
  tf32x3::cp_async_commit();
  int buf = 0;
  for (int c0 = 0; c0 < C; c0 += KC) {
    if (c0 + KC < C) {
      float* nxt = smem + (buf ^ 1) * STAGE;
      stage<VEC>(xb, w, offsets, nxt, nxt + XST, c0 + KC, cb0, C, Co);
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();   // this chunk's copies have landed
    __syncthreads();
    const float* xs = smem + buf * STAGE;
    const float* ws = xs + XST;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // A: window row 2 row + ky, output columns j = 16h + gid (+8) at tap
      // kx (window column 2j + kx: 16 more columns, 16 more positions),
      // channels tig (+4)
      const int p = (2 * row + ky) * IROW + col_pos(2 * gid + kx);
      FragA fa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* lo = xs + xq(p + 16 * h, 0) + tig;
        const float* hi = xs + xq(p + 16 * h, 1) + tig;
        fa[h].set({lo[0], lo[8 * KC], hi[0], hi[8 * KC]});
      }
      // B: weights of channels tig (+4), output channels 8j + gid, two n8
      // tiles at a time
      const float* wp = ws + (tap * KC + tig) * WS + gid;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        FragB fb[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          fb[jj].set(wp[16 * jp + 8 * jj], wp[4 * WS + 16 * jp + 8 * jj]);
        tf32x3::mma_tf32x3(acc[jp], fa, fb);
      }
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) tf32x3::fold(tot[jp], acc[jp]);
    __syncthreads();   // the buffer is consumed before it is refilled
    buf ^= 1;
  }

  // epilogue: bias, ReLU, store the pixels and channels in range
  const int oy = oy0 + row;
  if (oy >= Ho) return;
  const bool pairs = Co % 2 == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = cb0 + 8 * j + 2 * tig;
    if (co >= Co) continue;
    const bool two = co + 1 < Co;
    const float b0 = bias[co], b1 = two ? bias[co + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = ox0 + 16 * h + 8 * half + gid;
        if (ox >= Wo) continue;
        const float* t = tot[j >> 1][h][j & 1];
        float v0 = t[2 * half] + b0;
        float v1 = t[2 * half + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        float* o = y + (((long long)b * Ho + oy) * Wo + ox) * Co + co;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

template <bool VEC>
int launch(const float* x, const float* w, const float* bias, float* y,
           int B, int H, int W, int C, int Co, int relu, cudaStream_t s) {
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = (Wo + TW - 1) / TW;
  const long long tiles = (long long)((Ho + TH - 1) / TH) * tiles_w;
  if (tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int err =
      tf32x3::allow_smem((const void*)conv3x3_s2_kernel<VEC>, SMEM);
  if (err) return err;
  const dim3 grid((Co + CB - 1) / CB, (unsigned)tiles, B);
  conv3x3_s2_kernel<VEC><<<grid, NT, SMEM, s>>>(x, w, bias, y, H, W, C, Ho,
                                                 Wo, Co, tiles_w, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias [Co], y [B,H/2,W/2,Co]: float32,
// contiguous, 16-byte aligned; H and W even, H * W * C < 2^31 (offsets in
// one image are ints); any C and Co.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int conv2d_s2_forward(const float* x, const float* w,
                                 const float* bias, float* y, int B, int H,
                                 int W, int C, int Co, int relu,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || H % 2 || W % 2 ||
      (long long)H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0 && Co % 4 == 0)
    return launch<true>(x, w, bias, y, B, H, W, C, Co, relu, s);
  return launch<false>(x, w, bias, y, B, H, W, C, Co, relu, s);
}
