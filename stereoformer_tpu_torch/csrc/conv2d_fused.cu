// Fused stride-1 3x3 SAME convolution on Hopper (sm_90a), float32 by 3xTF32
// on the tensor cores.
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
// 580 flops per byte: 2.43 ms in float32 FMA at 67 TFLOP/s, 0.99 ms on the
// TF32 tensor cores with three products per float32 product (tf32x3.cuh).
//
// Design: the forward implicit GEMM Y[pix, Co] = Xcol[pix, 9C] W[9C, Co] on
// mma.sync m16n8k8 in 3xTF32, the mainloop of conv2d_s2.cu at stride 1. A
// block takes 4 x 32 output pixels of one image and 32 output channels (at
// each of RAFT's eight sites at least 5760 blocks for the 132 SMs; a tile's
// 2 or 3 channel blocks are neighbours in the grid) and walks C in chunks
// of 8. Per chunk it stages, double-buffered with cp.async, the
// 6 x 34 input window of its pixels and the chunk's 9 x 8 x 32 weights. Each
// window pixel holds its 8 channels, the two float4 halves swapped on every
// other 4-pixel group (`xq`), so the A-fragment loads (8 consecutive pixels
// x 4 channels a warp) hit 32 banks. A warp owns one output row: two m16
// tiles (32 columns) x four n8 tiles (32 channels). A k-step is one tap's 8
// channels: the A fragment is the window at that tap, the B fragment its
// weights, split to big and small at load and multiplied three times
// (mma_tf32x3). A chunk's 9 k-steps sum into fragments from zero, which are
// then added to float32 totals (tf32x3.cuh, `fold`).
//
// The prologue: cp.async cannot transform data in flight, so once a chunk
// has landed each thread rewrites the window pixels it copied itself (after
// cp.async.wait_group its own copies are visible to it, so no extra barrier)
// as relu(x s + t), in-image pixels only: padding stays 0. That is one
// shared-memory read and write of each staged value per chunk (about 3
// float4 per thread), where applying it at fragment load would repeat it for
// each of the 9 taps that read a pixel. Its scales and shifts are loaded one
// chunk ahead (1.5% at [4,576,960,64] on an H100 against loading them just
// before use).
//
// The weights are split at fragment load, as the A operand is, though the
// block's 4 warps load the same weights: splitting them once per block
// while staging (big and small kept in shared memory) measured 3.6% slower
// at [4,576,960,64] on an H100: it saves the warps' split instructions but
// reads twice the weight bytes from shared memory per MMA.
//
// Epilogue: bias, residual (float2 loads), ReLU and float2 stores from the
// C fragment layout. The moments of the stored values are reduced without
// float atomics, in a fixed order: each thread sums its 4 pixels per
// channel, a shuffle butterfly over the 8 lanes that share a channel pair,
// then the block's 4 warps in turn in shared memory, written as one partial
// per (tile, channel block); a second kernel sums a sample's partials in
// double precision, in a fixed order, so the result is deterministic and
// m2 - m1^2 keeps its digits. Pixels past H or W are neither stored nor
// counted (their MMA rows hold 0 + b).
//
// The bf16 form (conv2d_fused_forward_bf16), the Pallas kernel at
// out_dtype bf16: x, w, b and the residual bf16, s and t float32, y bf16:
//     in  = prologue ? bf16(relu(x * s + t)) : x
//     y   = bf16(relu?(conv3x3_SAME(in, w) + b + residual?)),
// the conv's products summed in float32 and the epilogue in float32, one
// rounding; the moments float32 sums of the rounded y. The same kernel,
// templated on the element, with the same tiles, grid and epilogue. A bf16
// widened to float32 is exact in TF32 (8 significant bits of 11), so one
// TF32 MMA gives the exact products: no split, a third of the float32
// form's MMAs. Staged as bf16: a window pixel's 8 channels are one 16-byte
// cp.async (a thread copies whole pixels, so its prologue covers all 8
// channels: x*s + t as one FMA, then ReLU and the rounding to bf16, in
// place), a weight row 32 bf16 + 8 of padding; the
// fragment loads widen each bf16 (a shift) as they read it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragA1;
using tf32x3::FragB;
using tf32x3::FragB1;
using bf16 = __nv_bfloat16;

constexpr int TH = 4;               // output rows per block
constexpr int TW = 32;              // output columns per block
constexpr int CB = 32;              // output channels per block
constexpr int KC = 8;               // input channels per staged chunk
constexpr int IW = TW + 2;          // window columns
constexpr int IH = TH + 2;          // window rows
constexpr int NP = IH * IW;         // window pixels
constexpr int XST = NP * KC;        // floats of one staged window
constexpr int WS = CB + 8;          // floats per staged weight row
constexpr int WST = 9 * KC * WS;    // floats of one chunk's weights
constexpr int STAGE = XST + WST;    // floats of one stage
// two stages, then the window's pixel offsets (`offsets`)
constexpr int SMEM = (2 * STAGE + NP) * (int)sizeof(float);
constexpr int NT = 32 * TH;         // one warp per output row
// resident blocks per SM: 12 warps, as conv2d_s2.cu
constexpr int MINB = 3;

static_assert(TH * 2 * CB <= 2 * STAGE, "moment scratch fits in a stage");

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
    const int gy = gy0 + p / IW, gx = gx0 + p % IW;
    offsets[p] =
        gy >= 0 && gy < H && gx >= 0 && gx < W ? (gy * W + gx) * C : -1;
  }
}

// A thread copies channel quad (threadIdx.x & 1) of window pixels
// threadIdx.x / 2, + NT/2, ...: the same pixels in every chunk, which is
// what lets it apply the prologue to them without a barrier.
__device__ __forceinline__ void stage(const float* __restrict__ xb,
                                      const float* __restrict__ w,
                                      const int* offsets, float* xs,
                                      float* ws, int c0, int cb0, int C,
                                      int Co) {
  const int q4 = threadIdx.x & 1, c = c0 + 4 * q4;
  for (int p = threadIdx.x >> 1; p < NP; p += NT / 2) {
    const int off = offsets[p];
    tf32x3::cp_async16(xs + xq(p, q4), off >= 0 ? xb + off + c : xb,
                       off >= 0 ? 16 : 0);
  }
  for (int idx = threadIdx.x; idx < 9 * KC * (CB / 4); idx += NT) {
    const int n4 = idx % (CB / 4);
    const int row = idx / (CB / 4);   // tap * KC + kk
    tf32x3::cp_async16(
        ws + row * WS + 4 * n4,
        w + ((long long)(row / KC) * C + c0 + row % KC) * Co + cb0 + 4 * n4,
        16);
  }
}

// relu(v * s + t) on the window pixels this thread staged, in the image only
__device__ __forceinline__ void prologue(float* xs, const int* offsets,
                                         float4 s, float4 t) {
  const int q4 = threadIdx.x & 1;
  for (int p = threadIdx.x >> 1; p < NP; p += NT / 2) {
    if (offsets[p] < 0) continue;
    float4* v = reinterpret_cast<float4*>(xs + xq(p, q4));
    float4 a = *v;
    a.x = fmaxf(fmaf(a.x, s.x, t.x), 0.f);
    a.y = fmaxf(fmaf(a.y, s.y, t.y), 0.f);
    a.z = fmaxf(fmaf(a.z, s.z, t.z), 0.f);
    a.w = fmaxf(fmaf(a.w, s.w, t.w), 0.f);
    *v = a;
  }
}

// the window's pixel offsets, after the two stages
__device__ __forceinline__ int* offsets_of(float* smem) {
  return reinterpret_cast<int*>(smem + 2 * STAGE);
}

// two consecutive values as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// store two values; the bf16 form rounds them and returns, in v0 and v1,
// the values it stored
__device__ __forceinline__ void store2(float* p, float& v0, float& v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float& v0, float& v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  const float2 f = __bfloat1622float2(h);
  v0 = f.x;
  v1 = f.y;
}

// The bf16 form's staging: window pixel p's 8 channels are the 16 bytes at
// float offset 4 p; weight row `row` (tap * KC + kk) holds 32 output
// channels at bf16 offset row * WSH. A thread copies window pixels
// threadIdx.x, + NT: whole pixels, so its prologue needs no barrier either.
constexpr int WSH = CB + 8;   // bf16 per staged weight row: 80 bytes

__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ xb,
                                           const bf16* __restrict__ w,
                                           const int* offsets, float* xs,
                                           float* ws, int c0, int cb0, int C,
                                           int Co) {
  for (int p = threadIdx.x; p < NP; p += NT) {
    const int off = offsets[p];
    tf32x3::cp_async16(xs + 4 * p, off >= 0 ? xb + off + c0 : xb,
                       off >= 0 ? 16 : 0);
  }
  bf16* wh = reinterpret_cast<bf16*>(ws);
  for (int idx = threadIdx.x; idx < 9 * KC * (CB / 8); idx += NT) {
    const int n8 = idx % (CB / 8);
    const int row = idx / (CB / 8);   // tap * KC + kk
    tf32x3::cp_async16(
        wh + row * WSH + 8 * n8,
        w + ((long long)(row / KC) * C + c0 + row % KC) * Co + cb0 + 8 * n8,
        16);
  }
}

// bf16(relu(v * s + t)) on the window pixels this thread staged, in the
// image only; s and t the chunk's 8 channels
__device__ __forceinline__ void prologue_bf16(float* xs, const int* offsets,
                                              const float4 (&s)[2],
                                              const float4 (&t)[2]) {
  const float sc[8] = {s[0].x, s[0].y, s[0].z, s[0].w,
                       s[1].x, s[1].y, s[1].z, s[1].w};
  const float tc[8] = {t[0].x, t[0].y, t[0].z, t[0].w,
                       t[1].x, t[1].y, t[1].z, t[1].w};
  for (int p = threadIdx.x; p < NP; p += NT) {
    if (offsets[p] < 0) continue;
    uint4* v = reinterpret_cast<uint4*>(xs + 4 * p);
    uint4 raw = *v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(
          fmaxf(fmaf(f.x, sc[2 * i], tc[2 * i]), 0.f),
          fmaxf(fmaf(f.y, sc[2 * i + 1], tc[2 * i + 1]), 0.f));
    }
    *v = raw;
  }
}

// the widened float32 bits of bf16 element i of a staged array
__device__ __forceinline__ uint32_t bf16_at(const float* base, int i) {
  return tf32x3::bf16_bits_to_f32(
      reinterpret_cast<const unsigned short*>(base)[i]);
}

template <typename T>
__global__ void __launch_bounds__(NT, MINB)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, const float* __restrict__ s,
               const float* __restrict__ t, const T* __restrict__ res,
               T* __restrict__ y, float* __restrict__ part, int H, int W,
               int C, int Co, int tiles_w, int tiles, int relu) {
  constexpr bool BF = sizeof(T) == 2;
  // 2 x [window, weights], then the window's pixel offsets
  extern __shared__ __align__(16) float smem[];

  // a tile's channel blocks are neighbours in the grid, so they run
  // together and share the window's reads
  const int ncb = Co / CB;
  const int cb0 = (blockIdx.x % ncb) * CB;
  const int tile = blockIdx.x / ncb;
  const int b = blockIdx.y;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
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

  const T* xb = x + img * C;
  // this thread's channels of the prologue's scales and shifts (a quad in
  // the float32 form, the chunk's 8 in the bf16 form), loaded one chunk
  // ahead so that their latency hides behind a chunk's MMAs
  const long long sq = (long long)b * C + (BF ? 0 : 4 * (threadIdx.x & 1));
  float4 sv[2], tv[2];
  sv[0] = sv[1] = tv[0] = tv[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_st = [&](int c0) {
#pragma unroll
    for (int i = 0; i < (BF ? 2 : 1); ++i) {
      sv[i] = *reinterpret_cast<const float4*>(s + sq + c0 + 4 * i);
      tv[i] = *reinterpret_cast<const float4*>(t + sq + c0 + 4 * i);
    }
  };
  auto stage_chunk = [&](float* dst, int c0) {
    if constexpr (BF)
      stage_bf16(xb, w, offsets_of(smem), dst, dst + XST, c0, cb0, C, Co);
    else
      stage(xb, w, offsets_of(smem), dst, dst + XST, c0, cb0, C, Co);
  };
  if (s != nullptr) load_st(0);
  int* offsets = offsets_of(smem);
  window_offsets(offsets, oy0 - 1, ox0 - 1, H, W, C);
  __syncthreads();
  stage_chunk(smem, 0);
  tf32x3::cp_async_commit();
  int buf = 0;
  for (int c0 = 0; c0 < C; c0 += KC) {
    if (c0 + KC < C) stage_chunk(smem + (buf ^ 1) * STAGE, c0 + KC);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();   // this chunk's copies have landed
    float* xs = smem + buf * STAGE;
    if (s != nullptr) {
      if constexpr (BF)
        prologue_bf16(xs, offsets, sv, tv);
      else
        prologue(xs, offsets, sv[0], tv[0]);
      if (c0 + KC < C) load_st(c0 + KC);
    }
    __syncthreads();
    const float* ws = xs + XST;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // A: window row row + ky, output columns j = 16h + gid (+8) at tap
      // kx (window column j + kx), channels tig (+4)
      const int p = (row + ky) * IW + gid + kx;
      if constexpr (BF) {
        FragA1 fa[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* px = xs + 4 * (p + 16 * h);
          fa[h].v[0] = bf16_at(px, tig);
          fa[h].v[1] = bf16_at(px + 4 * 8, tig);
          fa[h].v[2] = bf16_at(px, tig + 4);
          fa[h].v[3] = bf16_at(px + 4 * 8, tig + 4);
        }
        // B: weights of channels tig (+4), output channels 8j + gid
        const int wr = (tap * KC + tig) * WSH + gid;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          FragB1 fb[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            fb[jj].v[0] = bf16_at(ws, wr + 16 * jp + 8 * jj);
            fb[jj].v[1] = bf16_at(ws, wr + 4 * WSH + 16 * jp + 8 * jj);
          }
          tf32x3::mma_tf32x1(acc[jp], fa, fb);
        }
        continue;
      }
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

  // epilogue: bias, residual, ReLU, store the pixels in range; the moments
  // of the stored values (thread: channels 8j + 2 tig (+1), its 4 pixels)
  const int oy = oy0 + row;
  float m1[4][2], m2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = cb0 + 8 * j + 2 * tig;
    const float2 bv = load2(bias + co);
    m1[j][0] = m1[j][1] = m2[j][0] = m2[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = ox0 + 16 * h + 8 * half + gid;
        if (oy >= H || ox >= W) continue;
        const float* tt = tot[j >> 1][h][j & 1];
        float v0 = tt[2 * half] + bv.x;
        float v1 = tt[2 * half + 1] + bv.y;
        const long long o = (img + (long long)oy * W + ox) * Co + co;
        if (res != nullptr) {
          const float2 r = load2(res + o);
          v0 += r.x;
          v1 += r.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        // the moments below are of the stored (rounded) values
        store2(y + o, v0, v1);
        m1[j][0] += v0;
        m1[j][1] += v1;
        m2[j][0] = fmaf(v0, v0, m2[j][0]);
        m2[j][1] = fmaf(v1, v1, m2[j][1]);
      }
    }
  }
  if (part == nullptr) return;

  // butterfly over gid (lane bits 2-4): every lane of a tig ends with the
  // warp's sums of its channels
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m1[j][e] += __shfl_xor_sync(0xffffffffu, m1[j][e], off);
        m2[j][e] += __shfl_xor_sync(0xffffffffu, m2[j][e], off);
      }
  }
  // the stages are free: the main loop ends with a barrier
  float* red = smem;   // [TH][2][CB]
  if (gid == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(row * 2) * CB + 8 * j + 2 * tig + e] = m1[j][e];
        red[(row * 2 + 1) * CB + 8 * j + 2 * tig + e] = m2[j][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CB) {
    const int k = threadIdx.x / CB, n = threadIdx.x % CB;   // moment, channel
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < TH; ++r) sum += red[(r * 2 + k) * CB + n];
    part[(((long long)b * tiles + tile) * 2 + k) * Co + cb0 + n] = sum;
  }
}

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

template <typename T>
int launch(const T* x, const T* w, const T* bias, const float* s,
           const float* t, const T* res, T* y, float* part, float* s1,
           float* s2, int B, int H, int W, int C, int Co, int relu,
           void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || C % KC ||
      (Co != 64 && Co != 96) || (long long)H * W * C > 0x7fffffffLL ||
      (s == nullptr) != (t == nullptr) ||
      (part != nullptr && (s1 == nullptr || s2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int err = tf32x3::allow_smem((const void*)conv3x3_kernel<T>, SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  conv3x3_kernel<T><<<dim3((Co / CB) * tiles, B), NT, SMEM, st>>>(
      x, w, bias, s, t, res, y, part, H, W, C, Co, tiles_w, tiles, relu);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return (int)e;
  moments_kernel<<<dim3((2 * Co + 31) / 32, B), dim3(32, 32), 0, st>>>(
      part, s1, s2, tiles, Co);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias [Co], y [B,H,W,Co]: float32, contiguous,
// 16-byte aligned; H * W * C < 2^31 (offsets in one image are ints). s, t
// [B,C] (the prologue), res [B,H,W,Co] (the residual) and part, s1, s2 (the
// moments: scratch of B * ceil(H/4) * ceil(W/32) * 2 * Co floats, and S1,
// S2 [B,Co]) may each be null to leave that part out. C a multiple of 8; Co
// 64 or 96 (RAFT's routed sites).
// Returns cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int conv2d_fused_forward(const float* x, const float* w,
                                    const float* bias, const float* s,
                                    const float* t, const float* res, float* y,
                                    float* part, float* s1, float* s2, int B,
                                    int H, int W, int C, int Co, int relu,
                                    void* stream) {
  return launch(x, w, bias, s, t, res, y, part, s1, s2, B, H, W, C, Co, relu,
                stream);
}

// The bf16 form: x, w, bias, res and y bf16; s, t, part, s1 and s2
// float32; otherwise as conv2d_fused_forward.
extern "C" int conv2d_fused_forward_bf16(const void* x, const void* w,
                                         const void* bias, const float* s,
                                         const float* t, const void* res,
                                         void* y, float* part, float* s1,
                                         float* s2, int B, int H, int W,
                                         int C, int Co, int relu,
                                         void* stream) {
  return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                static_cast<const bf16*>(bias), s, t,
                static_cast<const bf16*>(res), static_cast<bf16*>(y), part,
                s1, s2, B, H, W, C, Co, relu, stream);
}
