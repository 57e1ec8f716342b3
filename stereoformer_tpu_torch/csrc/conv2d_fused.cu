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
// 2, 3 or 4 channel blocks, Co = 64, 96 or 128, are neighbours in the grid)
// and walks C in chunks of 8. Per chunk it stages, double-buffered with cp.async, the
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
// rounding; the moments float32 sums of the rounded y. Its own mainloop
// (`conv3x3_bf16_kernel`) on the bf16 tensor cores: a bf16 x bf16 product
// is exact in float32, so one mma.sync m16n8k16 (bf16 operands, float32
// accumulators) per 16 channels of a tap, twice the depth of a TF32
// m16n8k8 at twice its rate. At [4,576,960,64] the call is 163 GFLOP
// against 566 MB moved: 0.165 ms at 989 TFLOP/s, 0.169 ms at 3.35 TB/s.
//
// What bounds it in practice is the bytes each block stages from L2, not
// the MMAs: on an H100 the kernel with its MMAs taken out takes about two
// thirds of its time, and with one output row a warp (the weights staged
// twice as often) it is 1.4x slower (scripts/fused_bf16_probe.py). So a
// block takes 8 x 32 output pixels (4 warps, each two output rows: 4 m16
// tiles) and all 64 output channels at Co = 64, half of them at Co = 96
// (48) and Co = 128 (64, the Co = 64 template): the weights are staged once
// per 256 pixels and each input window once or twice. A tile's two channel
// blocks restage its window: at Co = 96 that makes the form slower than
// cuDNN's bf16 conv (PERF.md), and Co = 128 is left so too. C is walked in chunks through a cp.async ring (one
// barrier a chunk), 3 x 16 channels at Co = 64 and 2 x 32 at Co = 96, as
// deep as two blocks an SM leave room for. A window pixel's chunk is
// 16-byte units, swizzled (`xunit`) so that the 8 consecutive pixels an
// ldmatrix reads hit 8 distinct bank groups; the weights are staged as
// rows [tap][c][co] (HWIO, co contiguous), padded to an odd number of
// 16-byte units. A k-step is one tap's 16 channels:
// the A fragments come by ldmatrix.x4 from the window at that tap (each
// lane gives its own pixel's row, so the tap shift is a per-lane offset),
// the B fragments by ldmatrix.x4.trans from the weight rows: 32 MMAs per
// warp for 8 ldmatrix. Up to C = 96 each output's float32 fragment sums
// all of C (36 or 54 MMAs at C = 64 or 96) without a fold: the tensor
// core's truncating adds then stay within one bf16 ulp of float32 sums
// (tests/test_torch_tf32x3.py emulates them), and the registers a fold
// would take hold the second output row. Past C = 96 they do not: at
// C = 128 (72 MMAs) an output that a residual nearly cancels came 1.08
// ulps from the plain version on an H100. So where C > 96 a block takes
// 32 output channels (2, 3 or 4 blocks a tile) and folds each chunk's
// fragments into float32 totals (tf32x3.cuh, `fold`), in the registers
// the other 32 channels freed. C is any multiple of 8: the units
// and weight rows past C are zero-filled. The prologue rewrites, once a
// chunk has landed, the 16-byte units each thread copied itself (one FMA,
// ReLU and one rounding per value, padding left at 0). The epilogue adds
// bias and residual, applies ReLU, rounds once to bf16 and stages the
// block's output tile in shared memory, written out in 16-byte pieces,
// consecutive threads on consecutive bytes (the C fragments' own stores
// are 4 bytes a thread, 16 a pixel); the moments are the float32 form's,
// of the rounded values, one partial per 8 x 32 tile and output channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

// the bf16 form's widest unfolded C (96), a -D define from kernels.py's
// BF16_FOLD_C, by which ops/fused_conv.py also plans the grid
#ifndef BF16_FOLD_C
#error "build with -DBF16_FOLD_C (kernels.py: nvcc_flags)"
#endif

namespace {

using tf32x3::FragA;
using tf32x3::FragB;
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

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__global__ void __launch_bounds__(NT, MINB)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ s,
               const float* __restrict__ t, const float* __restrict__ res,
               float* __restrict__ y, float* __restrict__ part, int H, int W,
               int C, int Co, int tiles_w, int tiles, int relu) {
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

  const float* xb = x + img * C;
  // this thread's channel quad of the prologue's scales and shifts, loaded
  // one chunk ahead so that their latency hides behind a chunk's MMAs
  const long long sq = (long long)b * C + 4 * (threadIdx.x & 1);
  float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), tv = sv;
  auto load_st = [&](int c0) {
    sv = *reinterpret_cast<const float4*>(s + sq + c0);
    tv = *reinterpret_cast<const float4*>(t + sq + c0);
  };
  auto stage_chunk = [&](float* dst, int c0) {
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
      prologue(xs, offsets, sv, tv);
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

// ---------------------------------------------------------------------------
// The bf16 form: 4 warps, each RW output rows of 32 columns (2 RW m16
// tiles) and all NB output channels of the block (N8 = NB / 8 n8 tiles):
// NB = 64 (all of Co = 64, half of Co = 128) or 48 (half of Co = 96)
// where C <= 96, and NB = 32, each chunk folded, where C > 96. C in chunks of KC
// channels through a cp.async ring of STAGES. scripts/fused_bf16_probe.py
// builds it with other constants.
namespace bfk {

constexpr int RW = 2;               // output rows per warp
constexpr int BTH = 4 * RW;         // output rows per block
constexpr int BNP = (BTH + 2) * IW; // window pixels
constexpr int MINB = 2;             // resident blocks per SM

// the constants of a block with NB output channels
template <int NB>
struct Cfg {
  // input channels per staged chunk and stages of the ring, as two blocks
  // an SM leave room for (113 KB each): 3 x 16 channels at NB = 64, whose
  // weight rows are the wider, and 2 x 32 at NB = 48 (the fastest of the
  // depths scripts/fused_bf16_probe.py tries, on an H100); 4 x 16 at
  // NB = 32, whose chunk of 9 MMAs a fragment is folded
  static constexpr int KC = NB == 48 ? 32 : 16;
  static constexpr int STAGES = NB == 64 ? 3 : NB == 48 ? 2 : 4;
  static constexpr bool FOLD = NB == 32;
  static constexpr int UP = KC / 8;         // 16-byte units of a pixel
  static constexpr int XB = BNP * 16 * UP;  // bytes of a staged window
  // a staged weight row (tap, input channel), and a pixel of the staged
  // output tile: NB channels and 8 of padding, an odd number of 16-byte
  // units, so that the 8 rows an ldmatrix reads, and the 8 pixels of a C
  // fragment, hit distinct banks
  static constexpr int WROW = 2 * (NB + 8);
  static constexpr int STAGE = XB + 9 * KC * WROW;
  // STAGES x [window, weights], then the window's pixel offsets
  static constexpr int BYTES = STAGES * STAGE + BNP * (int)sizeof(int);
  // the output tile and the moment scratch, in the stages after the loop
  static constexpr int TILE = BTH * TW * WROW;
  static_assert(TILE + 4 * 2 * NB * (int)sizeof(float) <= STAGES * STAGE,
                "the output tile and the moment scratch fit in the stages");
};

// the byte offset of 16-byte unit u (channels 8u..8u+7 of the chunk) of
// window pixel p, UP units a pixel: a 128-byte line holds 8 / UP pixels,
// and the units of a pixel are permuted by its line's index, so that 8
// consecutive pixels' unit u lie in 8 distinct bank groups
template <int UP>
__device__ __forceinline__ int xunit(int p, int u) {
  return (p * UP + (u ^ (((unsigned)p / (8 / UP)) % UP))) << 4;
}

using bf16mma::ldmatrix_x4;
using bf16mma::ldmatrix_x4_trans;
using bf16mma::mma_bf16;
using bf16mma::smem_addr;

// Epilogue: bias, residual, ReLU and the rounding to bf16 of the block's
// output tile (a thread: channels 8 j + 2 tig (+1) of n8 tile j at its
// warp's row h / 2, columns 16 (h % 2) + gid (+8)), staged in shared
// memory and written out in 16-byte pieces, consecutive threads on
// consecutive bytes of a pixel's NB channels; the moments of the rounded
// values, reduced as the float32 form's (a butterfly over gid, then the 4
// warps in turn), one partial per tile and channel. `sm`: the stages, which
// no warp reads any more.
template <int NB>
__device__ __forceinline__ void epilogue(
    const float (&acc)[2 * RW][NB / 8][4], const bf16* __restrict__ bias,
    const bf16* __restrict__ res, bf16* __restrict__ y,
    float* __restrict__ part, unsigned char* sm, long long img, int b,
    int tile, int tiles, int oy0, int ox0, int cb0, int H, int W, int Co,
    int relu) {
  using K = Cfg<NB>;
  constexpr int N8 = NB / 8;
  float* red = reinterpret_cast<float*>(sm + K::TILE);   // [warp][2][NB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float m1[N8][2], m2[N8][2];
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    const int co = cb0 + 8 * j + 2 * tig;
    const float2 bv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + co));
    m1[j][0] = m1[j][1] = m2[j][0] = m2[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2 * RW; ++h) {
      const int r = RW * warp + (h >> 1);   // the tile's row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * (h & 1) + 8 * half + gid;
        const int oy = oy0 + r, ox = ox0 + col;
        if (oy >= H || ox >= W) continue;
        float v0 = acc[h][j][2 * half] + bv.x;
        float v1 = acc[h][j][2 * half + 1] + bv.y;
        if (res != nullptr) {
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  res + (img + (long long)oy * W + ox) * Co + co));
          v0 += rv.x;
          v1 += rv.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(
            sm + (r * TW + col) * K::WROW + 2 * (8 * j + 2 * tig)) = hv;
        // the moments are of the stored (rounded) values
        const float2 f = __bfloat1622float2(hv);
        m1[j][0] += f.x;
        m1[j][1] += f.y;
        m2[j][0] = fmaf(f.x, f.x, m2[j][0]);
        m2[j][1] = fmaf(f.y, f.y, m2[j][1]);
      }
    }
  }
  if (part != nullptr) {
    // butterfly over gid (lane bits 2-4): every lane of a tig ends with
    // the warp's sums of its channels
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m1[j][e] += __shfl_xor_sync(0xffffffffu, m1[j][e], off);
          m2[j][e] += __shfl_xor_sync(0xffffffffu, m2[j][e], off);
        }
    }
    if (gid == 0) {
#pragma unroll
      for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(warp * 2) * NB + 8 * j + 2 * tig + e] = m1[j][e];
          red[(warp * 2 + 1) * NB + 8 * j + 2 * tig + e] = m2[j][e];
        }
    }
  }
  __syncthreads();
  // the tile out: unit u (8 channels) of tile pixel px, N8 units a pixel
  for (int i = threadIdx.x; i < BTH * TW * N8; i += NT) {
    const int u = i % N8, px = i / N8;
    const int oy = oy0 + px / TW, ox = ox0 + px % TW;
    if (oy >= H || ox >= W) continue;
    *reinterpret_cast<uint4*>(y + (img + (long long)oy * W + ox) * Co + cb0 +
                              8 * u) =
        *reinterpret_cast<const uint4*>(sm + px * K::WROW + 16 * u);
  }
  if (part == nullptr || threadIdx.x >= 2 * NB) return;
  const int k = threadIdx.x / NB, n = threadIdx.x % NB;   // moment, channel
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) sum += red[(r * 2 + k) * NB + n];
  part[(((long long)b * tiles + tile) * 2 + k) * Co + cb0 + n] = sum;
}

}  // namespace bfk

template <int NB>
__global__ void __launch_bounds__(NT, bfk::MINB)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias,
                    const float* __restrict__ s, const float* __restrict__ t,
                    const bf16* __restrict__ res, bf16* __restrict__ y,
                    float* __restrict__ part, int H, int W, int C, int Co,
                    int tiles_w, int tiles, int relu) {
  using K = bfk::Cfg<NB>;
  constexpr int KC = K::KC, UP = K::UP, XB = K::XB, NPX = bfk::BNP;
  constexpr int RW = bfk::RW, ST = K::STAGES;
  constexpr int N8 = NB / 8, MT = 2 * RW;   // n8 and m16 tiles of a warp
  extern __shared__ __align__(16) unsigned char sm[];

  // the channel blocks of a tile (2 at Co = 96 and 128) are neighbours in
  // the grid
  const int ncb = Co / NB;
  const int cb0 = (blockIdx.x % ncb) * NB;
  const int tile = blockIdx.x / ncb;
  const int b = blockIdx.y;
  const int oy0 = (tile / tiles_w) * bfk::BTH;
  const int ox0 = (tile % tiles_w) * TW;
  const long long img = (long long)b * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a thread copies 16-byte unit q (channels 8q..8q+7 of each chunk) of
  // window pixels threadIdx.x / UP, + NT/UP, ...: the same in every chunk,
  // so its prologue needs no barrier
  const int q = threadIdx.x % UP;

  // [m16 tile h][n8 tile j]: the sums over all of C, or (FOLD) over a
  // chunk, folded into the float32 totals tot
  float acc[MT][N8][4], tot[MT][N8][4];
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = tot[h][j][e] = 0.f;

  const bf16* xb = x + img * C;
  // offsets[p]: where window pixel p starts in xb, or -1 outside the image
  int* offsets = reinterpret_cast<int*>(sm + ST * K::STAGE);
  auto stage = [&](int k) {   // chunk k into its stage, k % ST
    unsigned char* dst = sm + (k % ST) * K::STAGE;
    const int c0 = k * KC, c = c0 + 8 * q;
    for (int p = threadIdx.x / UP; p < NPX; p += NT / UP) {
      const int off = offsets[p];
      const bool in = off >= 0 && c < C;
      tf32x3::cp_async16(dst + bfk::xunit<UP>(p, q), in ? xb + off + c : xb,
                         in ? 16 : 0);
    }
    unsigned char* ws = dst + XB;
    for (int idx = threadIdx.x; idx < 9 * KC * N8; idx += NT) {
      const int n8 = idx % N8;
      const int r = idx / N8;   // tap * KC + kk
      const int cc = c0 + r % KC;
      const bool in = cc < C;
      tf32x3::cp_async16(
          ws + r * K::WROW + 16 * n8,
          in ? w + ((long long)(r / KC) * C + cc) * Co + cb0 + 8 * n8 : w,
          in ? 16 : 0);
    }
  };
  // this thread's 8 channels of the prologue's scales and shifts, loaded
  // one chunk ahead so that their latency hides behind a chunk's MMAs
  float4 sv[2], tv[2];
  sv[0] = sv[1] = tv[0] = tv[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_st = [&](int c0) {
    const int c = c0 + 8 * q;
    if (c >= C) return;
    const long long o = (long long)b * C + c;
    sv[0] = *reinterpret_cast<const float4*>(s + o);
    sv[1] = *reinterpret_cast<const float4*>(s + o + 4);
    tv[0] = *reinterpret_cast<const float4*>(t + o);
    tv[1] = *reinterpret_cast<const float4*>(t + o + 4);
  };
  // bf16(relu(v * s + t)) on the units this thread staged, in the image
  // and in C only: padding and zero-filled channels stay 0
  auto prologue = [&](unsigned char* xs, int c0) {
    if (c0 + 8 * q >= C) return;
    const float sc[8] = {sv[0].x, sv[0].y, sv[0].z, sv[0].w,
                         sv[1].x, sv[1].y, sv[1].z, sv[1].w};
    const float tc[8] = {tv[0].x, tv[0].y, tv[0].z, tv[0].w,
                         tv[1].x, tv[1].y, tv[1].z, tv[1].w};
    for (int p = threadIdx.x / UP; p < NPX; p += NT / UP) {
      if (offsets[p] < 0) continue;
      uint4* v = reinterpret_cast<uint4*>(xs + bfk::xunit<UP>(p, q));
      uint4 raw = *v;
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hv[i]);
        hv[i] = __floats2bfloat162_rn(
            fmaxf(fmaf(f.x, sc[2 * i], tc[2 * i]), 0.f),
            fmaxf(fmaf(f.y, sc[2 * i + 1], tc[2 * i + 1]), 0.f));
      }
      *v = raw;
    }
  };

  if (s != nullptr) load_st(0);
  for (int p = threadIdx.x; p < NPX; p += NT) {
    const int gy = oy0 - 1 + p / IW, gx = ox0 - 1 + p % IW;
    offsets[p] =
        gy >= 0 && gy < H && gx >= 0 && gx < W ? (gy * W + gx) * C : -1;
  }
  __syncthreads();
  const int nch = (C + KC - 1) / KC;
  // the first ST - 1 chunks in flight; one commit group per chunk (empty
  // past the last), so that group k is chunk k's
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (k < nch) stage(k);
    tf32x3::cp_async_commit();
  }

  // ldmatrix rows: lane i gives row i % 16 of the A tile (an output
  // column, so a window pixel) and of the B tile (an input channel), at
  // k-half (A) or n8 tile (B) i / 16
  const int lr = lane & 15, lh = lane >> 4;
  const int pa = RW * warp * IW + lr;   // the lane's pixel at tap (0, 0)
  const uint32_t b_lane = (uint32_t)(lr * K::WROW + 16 * lh);
  for (int k = 0; k < nch; ++k) {
    tf32x3::cp_async_wait<ST - 2>();   // chunk k's copies have landed
    unsigned char* xs = sm + (k % ST) * K::STAGE;
    if (s != nullptr) {
      prologue(xs, k * KC);
      if (k + 1 < nch) load_st((k + 1) * KC);
    }
    // chunk k is whole and rewritten, and chunk k - 1's stage is consumed
    __syncthreads();
    if (k + ST - 1 < nch) stage(k + ST - 1);
    tf32x3::cp_async_commit();
    const uint32_t xa = bfk::smem_addr(xs);
    const uint32_t wa = xa + XB + b_lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // A: the warp's rows, output columns 16 (h % 2) + (0..15) at tap
        // (ky, kx), channels 16 ks + (0..15) of the chunk
        uint32_t a[MT][4];
#pragma unroll
        for (int h = 0; h < MT; ++h)
          bfk::ldmatrix_x4(
              a[h], xa + bfk::xunit<UP>(pa + ((h >> 1) + ky) * IW + kx +
                                            16 * (h & 1),
                                        2 * ks + lh));
        // B: the same channels, output channels 16 jp + (0..15)
#pragma unroll
        for (int jp = 0; jp < N8 / 2; ++jp) {
          uint32_t bq[4];
          bfk::ldmatrix_x4_trans(
              bq, wa + (tap * KC + 16 * ks) * K::WROW + 32 * jp);
#pragma unroll
          for (int h = 0; h < MT; ++h) {
            bfk::mma_bf16(acc[h][2 * jp], a[h], bq[0], bq[1]);
            bfk::mma_bf16(acc[h][2 * jp + 1], a[h], bq[2], bq[3]);
          }
        }
      }
    }
    if constexpr (K::FOLD) tf32x3::fold(tot, acc);
  }
  __syncthreads();   // the stages are consumed: the epilogue reuses them

  bfk::epilogue<NB>(K::FOLD ? tot : acc, bias, res, y, part, sm, img, b,
                    tile, tiles, oy0, ox0, cb0, H, W, Co, relu);
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

// What both forms refuse (0 when the arguments are taken)
int check(int B, int H, int W, int C, int Co, const void* s, const void* t,
          const float* part, const float* s1, const float* s2) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || C % 8 ||
      (Co != 64 && Co != 96 && Co != 128) ||
      (long long)H * W * C > 0x7fffffffLL ||
      (s == nullptr) != (t == nullptr) ||
      (part != nullptr && (s1 == nullptr || s2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the grid's tiles along W, and in all for tiles of th x TW pixels (TH in
// the float32 form, bfk::BTH in the bf16 form)
int tiles_w_of(int W) { return (W + TW - 1) / TW; }
int tiles_of(int H, int W, int th) {
  return ((H + th - 1) / th) * tiles_w_of(W);
}

// the moments' second pass, after the conv's launch
int launch_moments(const float* part, float* s1, float* s2, int B, int tiles,
                   int Co, cudaStream_t st) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return (int)e;
  moments_kernel<<<dim3((2 * Co + 31) / 32, B), dim3(32, 32), 0, st>>>(
      part, s1, s2, tiles, Co);
  return (int)cudaGetLastError();
}

int launch(const float* x, const float* w, const float* bias, const float* s,
           const float* t, const float* res, float* y, float* part, float* s1,
           float* s2, int B, int H, int W, int C, int Co, int relu,
           void* stream) {
  int err = check(B, H, W, C, Co, s, t, part, s1, s2);
  if (err) return err;
  err = tf32x3::allow_smem((const void*)conv3x3_kernel, SMEM);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = tiles_of(H, W, TH);
  conv3x3_kernel<<<dim3((Co / CB) * tiles, B), NT, SMEM, st>>>(
      x, w, bias, s, t, res, y, part, H, W, C, Co, tiles_w_of(W), tiles,
      relu);
  return launch_moments(part, s1, s2, B, tiles, Co, st);
}

template <int NB>
int launch_bf16(const bf16* x, const bf16* w, const bf16* bias,
                const float* s, const float* t, const bf16* res, bf16* y,
                float* part, float* s1, float* s2, int B, int H, int W, int C,
                int Co, int relu, cudaStream_t st) {
  constexpr int bytes = bfk::Cfg<NB>::BYTES;
  const int err =
      tf32x3::allow_smem((const void*)conv3x3_bf16_kernel<NB>, bytes);
  if (err) return err;
  const int tiles = tiles_of(H, W, bfk::BTH);
  conv3x3_bf16_kernel<NB><<<dim3((Co / NB) * tiles, B), NT, bytes, st>>>(
      x, w, bias, s, t, res, y, part, H, W, C, Co, tiles_w_of(W), tiles,
      relu);
  return launch_moments(part, s1, s2, B, tiles, Co, st);
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias [Co], y [B,H,W,Co]: float32, contiguous,
// 16-byte aligned; H * W * C < 2^31 (offsets in one image are ints). s, t
// [B,C] (the prologue), res [B,H,W,Co] (the residual) and part, s1, s2 (the
// moments: scratch of B * ceil(H/4) * ceil(W/32) * 2 * Co floats, and S1,
// S2 [B,Co]) may each be null to leave that part out. C a multiple of 8; Co
// 64, 96 or 128 (the widths of the sites nn/blocks.py routes).
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
// float32; the moments' scratch B * ceil(H/8) * ceil(W/32) * 2 * Co floats
// (one partial per 8 x 32 tile and output channel); otherwise as
// conv2d_fused_forward.
extern "C" int conv2d_fused_forward_bf16(const void* x, const void* w,
                                         const void* bias, const float* s,
                                         const float* t, const void* res,
                                         void* y, float* part, float* s1,
                                         float* s2, int B, int H, int W,
                                         int C, int Co, int relu,
                                         void* stream) {
  const int err = check(B, H, W, C, Co, s, t, part, s1, s2);
  if (err) return err;
  // blocks of 32 channels with folded sums past C = BF16_FOLD_C (96); else
  // of 48 at Co = 96, of 64 at Co = 64 and 128
  auto* go = C > BF16_FOLD_C ? &launch_bf16<32>
             : Co == 96      ? &launch_bf16<48>
                             : &launch_bf16<64>;
  return go(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
            static_cast<const bf16*>(bias), s, t,
            static_cast<const bf16*>(res), static_cast<bf16*>(y), part, s1,
            s2, B, H, W, C, Co, relu, (cudaStream_t)stream);
}
