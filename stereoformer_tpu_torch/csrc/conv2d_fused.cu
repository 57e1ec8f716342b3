// Fused stride-1 3x3 SAME convolution on Hopper (sm_90a), float32.
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/conv2d.py::_forward
// (body `_kernel`) and with it its four entry points conv2d_fused,
// conv2d_fused_prologue, conv2d_fused_stats and conv2d_fused_prologue_stats.
// With x [B,H,W,C] and y [B,H,W,Co] NHWC, w [3,3,C,Co] HWIO, b [Co]:
//     in  = prologue ? relu(x * s[b,c] + t[b,c]) : x      (s, t [B,C])
//     y   = relu?(conv3x3_SAME(in, w) + b + residual?)
//     S1[b,co] = sum_{h,w} y,  S2[b,co] = sum_{h,w} y^2   (if stats)
// The SAME padding is zero: taps outside the image read 0, never relu(t).
//
// What bounds it on the H100: operations. At RAFT's full-resolution layer1
// ([4,576,960,64] -> 64) one call is 163 GFLOP against 283 MB moved, about
// 580 flops per byte, far above the card's float32 balance (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte). So the design keeps the FMA pipes fed from
// registers and shared memory, and reads each input from device memory about
// once.
//
// Design: an implicit GEMM in float32 FMA (M = pixels, N = Co, K = 9 C). A
// block computes an 8 x 32 tile of output pixels of one image for all Co
// channels. It walks C in chunks of 8 input channels: each chunk stages the
// 10 x 34 halo tile of the input (prologue applied, zeros outside the image)
// channel-major in shared memory, and the chunk's 9 x 8 x Co weights. A warp
// owns 16 output channels and 4 rows; its lane is the output column. Per
// input channel a thread reads the 6 x 3 input values its 4 x 9 taps need
// once, and each weight row as a broadcast float4, then does 576 FMAs from
// registers. Bias, residual and ReLU fuse into the epilogue. The moments are
// reduced without float atomics, in a fixed order: a butterfly over the warp's
// lanes, then the block's two row groups, written as one partial per block;
// a second kernel sums a sample's partials in double precision, in a fixed
// order, so the result is deterministic and m2 - m1^2 keeps its digits.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;              // output rows per block
constexpr int TW = 32;             // output columns per block (one per lane)
constexpr int RPT = 4;             // output rows per thread
constexpr int KC = 8;              // input channels per staged chunk
constexpr int TN = 16;             // output channels per thread (per warp)
constexpr int IH = TH + 2;         // halo tile rows
constexpr int IW = TW + 2;         // halo tile columns
constexpr int IPLANE = IH * IW;    // one channel of the halo tile
constexpr int RG = TH / RPT;       // row groups per block

template <int CO>
struct Shape {
  static constexpr int CG = CO / TN;          // channel groups (warps per row group)
  static constexpr int NT = CG * RG * 32;     // threads per block
  static constexpr int MINB = NT >= 384 ? 1 : 512 / NT;
};

template <int CO>
__global__ void __launch_bounds__(Shape<CO>::NT, Shape<CO>::MINB)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ s,
               const float* __restrict__ t, const float* __restrict__ res,
               float* __restrict__ y, float* __restrict__ part, int H, int W,
               int C, int tiles_w, int relu) {
  constexpr int NT = Shape<CO>::NT;
  constexpr int CG = Shape<CO>::CG;
  __shared__ __align__(16) float xs[KC * IPLANE];     // [KC][IH][IW]
  __shared__ __align__(16) float ws[9 * KC * CO];     // [tap][KC][CO]

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_w) * TH;
  const int x0 = (tile % tiles_w) * TW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = warp % CG;
  const int rg = warp / CG;
  const int co0 = cg * TN;
  const int r0 = rg * RPT;
  const long long img = (long long)b * H * W;

  float acc[RPT][TN];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();   // the previous chunk is consumed
    // the halo tile, channel-major; zeros outside the image, prologue inside
    for (int idx = threadIdx.x; idx < IPLANE * (KC / 4); idx += NT) {
      const int q = idx % (KC / 4);
      const int p = idx / (KC / 4);
      const int gy = y0 + p / IW - 1;
      const int gx = x0 + p % IW - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = c0 + 4 * q;
        v = *reinterpret_cast<const float4*>(
            x + ((img + (long long)gy * W + gx) * C + c));
        if (s != nullptr) {
          const float* sb = s + (long long)b * C + c;
          const float* tb = t + (long long)b * C + c;
          v.x = fmaxf(fmaf(v.x, sb[0], tb[0]), 0.f);
          v.y = fmaxf(fmaf(v.y, sb[1], tb[1]), 0.f);
          v.z = fmaxf(fmaf(v.z, sb[2], tb[2]), 0.f);
          v.w = fmaxf(fmaf(v.w, sb[3], tb[3]), 0.f);
        }
      }
      float* dst = xs + 4 * q * IPLANE + p;
      dst[0] = v.x;
      dst[IPLANE] = v.y;
      dst[2 * IPLANE] = v.z;
      dst[3 * IPLANE] = v.w;
    }
    // the chunk's weights: for each tap, KC contiguous rows of CO
    for (int idx = threadIdx.x; idx < 9 * KC * CO / 4; idx += NT) {
      const int tap = idx / (KC * CO / 4);
      const int rem = idx % (KC * CO / 4);
      reinterpret_cast<float4*>(ws)[idx] = *reinterpret_cast<const float4*>(
          w + ((long long)tap * C + c0) * CO + 4 * rem);
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
      float in[RPT + 2][3];
      const float* xr = xs + c * IPLANE + r0 * IW + lane;
#pragma unroll
      for (int i = 0; i < RPT + 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) in[i][j] = xr[i * IW + j];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wr = reinterpret_cast<const float4*>(
              ws + ((ky * 3 + kx) * KC + c) * CO + co0);
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
            const float a = in[i + ky][kx];
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a, wv[n], acc[i][n]);
          }
        }
      }
    }
  }

  // epilogue: bias, residual, ReLU, store; the moments of the stored values
  float bv[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) bv[n] = bias[co0 + n];
  float m1[TN], m2[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) m1[n] = m2[n] = 0.f;
  const int gx = x0 + lane;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gy = y0 + r0 + i;
    if (gy >= H || gx >= W) continue;
    const long long o = (img + (long long)gy * W + gx) * CO + co0;
    float v[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) v[n] = acc[i][n] + bv[n];
    if (res != nullptr) {
#pragma unroll
      for (int n4 = 0; n4 < TN / 4; ++n4) {
        const float4 r = *reinterpret_cast<const float4*>(res + o + 4 * n4);
        v[4 * n4] += r.x;
        v[4 * n4 + 1] += r.y;
        v[4 * n4 + 2] += r.z;
        v[4 * n4 + 3] += r.w;
      }
    }
    if (relu) {
#pragma unroll
      for (int n = 0; n < TN; ++n) v[n] = fmaxf(v[n], 0.f);
    }
#pragma unroll
    for (int n4 = 0; n4 < TN / 4; ++n4)
      *reinterpret_cast<float4*>(y + o + 4 * n4) =
          make_float4(v[4 * n4], v[4 * n4 + 1], v[4 * n4 + 2], v[4 * n4 + 3]);
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      m1[n] += v[n];
      m2[n] = fmaf(v[n], v[n], m2[n]);
    }
  }
  if (part == nullptr) return;

  // butterfly over the lanes (every lane ends with the warp's sums)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      m1[n] += __shfl_xor_sync(0xffffffffu, m1[n], off);
      m2[n] += __shfl_xor_sync(0xffffffffu, m2[n], off);
    }
  }
  __syncthreads();   // xs is free: every thread has left the main loop
  float* red = xs;   // [RG][2][CO]
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      red[(rg * 2) * CO + co0 + n] = m1[n];
      red[(rg * 2 + 1) * CO + co0 + n] = m2[n];
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < 2 * CO; v += NT) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) sum += red[g * 2 * CO + v];
    part[((long long)b * gridDim.x + tile) * 2 * CO + v] = sum;
  }
}

static_assert(RG * 2 * 96 <= KC * IPLANE, "moment scratch fits in xs");

// Sum each sample's per-block partials [B][tiles][2*Co] in double, in a
// fixed order: thread (v, k) takes tiles k, k+32, ...; then one thread per v
// adds the 32 in turn. Writes S1 [B,Co] and S2 [B,Co].
__global__ void moments_kernel(const float* __restrict__ part,
                               float* __restrict__ s1, float* __restrict__ s2,
                               int tiles, int Co) {
  __shared__ double acc[32][33];
  const int b = blockIdx.y;
  const int v = blockIdx.x * 32 + threadIdx.x;
  const int k = threadIdx.y;
  double sum = 0.0;
  if (v < 2 * Co) {
    const float* p = part + (long long)b * tiles * 2 * Co + v;
    for (int i = k; i < tiles; i += 32) sum += (double)p[(long long)i * 2 * Co];
  }
  acc[k][threadIdx.x] = sum;
  __syncthreads();
  if (k != 0 || v >= 2 * Co) return;
  double total = 0.0;
  for (int i = 0; i < 32; ++i) total += acc[i][threadIdx.x];
  if (v < Co)
    s1[(long long)b * Co + v] = (float)total;
  else
    s2[(long long)b * Co + v - Co] = (float)total;
}

template <int CO>
int launch(const float* x, const float* w, const float* bias, const float* s,
           const float* t, const float* res, float* y, float* part, float* s1,
           float* s2, int B, int H, int W, int C, int relu,
           cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  conv3x3_kernel<CO><<<dim3(tiles, B), Shape<CO>::NT, 0, stream>>>(
      x, w, bias, s, t, res, y, part, H, W, C, tiles_w, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  moments_kernel<<<dim3((2 * CO + 31) / 32, B), dim3(32, 32), 0, stream>>>(
      part, s1, s2, tiles, CO);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias [Co], y [B,H,W,Co]: float32, contiguous,
// 16-byte aligned. s, t [B,C] (the prologue), res [B,H,W,Co] (the residual)
// and part, s1, s2 (the moments: scratch of B * ceil(H/8) * ceil(W/32) * 2 *
// Co floats, and S1, S2 [B,Co]) may each be null to leave that part out. C a
// multiple of 8; Co 64 or 96 (RAFT's routed sites).
// Returns cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int conv2d_fused_forward(const float* x, const float* w,
                                    const float* bias, const float* s,
                                    const float* t, const float* res, float* y,
                                    float* part, float* s1, float* s2, int B,
                                    int H, int W, int C, int Co, int relu,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % KC ||
      (s == nullptr) != (t == nullptr) ||
      (part != nullptr && (s1 == nullptr || s2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Co) {
    case 64: return launch<64>(x, w, bias, s, t, res, y, part, s1, s2, B, H, W, C, relu, st);
    case 96: return launch<96>(x, w, bias, s, t, res, y, part, s1, s2, B, H, W, C, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
