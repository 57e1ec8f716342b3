// Weight gradient of a stride-1 3x3 SAME convolution on Hopper (sm_90a),
// float32 by 3xTF32 on the tensor cores.
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
// read, about 144 flops per byte. In float32 FMA that is 2.03 ms at the
// card's 67 TFLOP/s; on the TF32 tensor cores, three products per float32
// product (tf32x3.cuh), 0.82 ms at 495 TFLOP/s.
//
// Design: for each tap row di, dw[di] is the GEMM
//     dW[(dj, c), co] = sum_pix Xcol[(dj, c), pix] * G[pix, co],
// M = 3 x 32 rows for a chunk of 32 input channels, N = Co, K = pixels,
// split over pixels. Block (di * C/32 + chunk, s) takes tap row di, the
// chunk's 32 channels, all Co outputs and the s-th of nsplit equal runs of
// 2 x 40 pixel tiles (the blocks of one run share their tiles in L2). Per
// tile it stages, double-buffered with cp.async (tile k+1 loads while tile
// k's MMAs run), the 2 x 42 x-halo of its 32 channels (rows h + di - 1,
// zeros outside the image; 40 floats a pixel, so the A-fragment loads hit
// 32 banks) and the 2 x 40 x Co tile of g (zeros past the image; Co + 8
// floats a pixel, likewise). Warps are 2 (M) x Co/32 (N); a warp owns 48
// rows x 32 columns of dW: three m16 tiles (one dj and 16 channels each)
// and four n8 tiles, so each element it loads and splits feeds three or
// four MMAs. A k-step is 8 pixels of one row: the A fragment is x at
// those pixels shifted by dj, the B fragment g at them, split to big and
// small at load and multiplied three times (mma_tf32x3). A tile's 10
// k-steps sum into fragments from zero, which are then added to float32
// totals (tf32x3.cuh, `fold`). Each block writes its partial dW to a
// workspace; a second kernel sums the nsplit partials of each element in
// double precision in a fixed order, so the result is deterministic and
// takes no float atomics. The wrapper (ops/dw_conv.py::dw_plan) picks
// nsplit so that the grid fills the card in whole waves.
//
// The bf16 form (conv2d_dw_bf16), the Pallas kernel on bf16 x and g with
// `_dw`'s cast to the bf16 weight: the products summed in float32 and the
// result rounded once to bf16. At the same site it is the same 136 GFLOP
// against 472 MB read: 0.141 ms at 3.35 TB/s, 0.137 ms at the card's 989
// TFLOP/s of bf16, so bytes bound it, just. Its own mainloop (`dw_bf16_kernel`) keeps the float32 form's
// grid, split and fixed-order reduction; a bf16 x bf16 product is exact in
// float32, so each k-step is one mma.sync m16n8k16 (bf16 operands, float32
// accumulators) per tile, with no split. A k-step is 16 pixels of one
// row; both operands are read from the NHWC tiles by ldmatrix.x4.trans
// (A: 8 pixels x 8 channels of x per matrix, M = channel, K = pixel, the
// tap shift dj a per-lane offset; B: 8 pixels x 8 output channels of g).
// A tile is 2 x 32 pixels (4 k-steps); a staged pixel is its channels and
// 16 bytes of padding, an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads hit distinct banks. The tile sums are folded into float32
// totals as in the float32 form: a block sums thousands of MMAs, and the
// tensor core's truncating adds would drift over that many. The reduction
// sums the partials in double, in a fixed order, and rounds once to bf16
// (through float32, as the float32 sum the Pallas kernel returns is
// rounded): two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int TH = 2;             // pixel rows per tile
constexpr int TW = 40;            // pixel columns per tile
constexpr int TP = TH * TW;       // pixels per tile
constexpr int KSTEPS = TP / 8;    // k-steps (8 pixels of one row) per tile
constexpr int KC = 32;            // input channels per block
constexpr int XW = TW + 2;        // halo columns
constexpr int XS = KC + 8;        // floats per staged x pixel (bank spread)
constexpr int XST = TH * XW * XS; // floats of one staged x tile

template <int CO>
struct Shape {
  static constexpr int GS = CO + 8;          // floats per staged g pixel
  static constexpr int GST = TP * GS;        // floats of one staged g tile
  static constexpr int STAGE = XST + GST;
  static constexpr int SMEM = 2 * STAGE * (int)sizeof(float);
  static constexpr int WN = CO / 32;         // warps along N
  static constexpr int NT = 32 * 2 * WN;     // threads: 128 or 192
  // resident blocks per SM, 12 warps either way (ops/dw_conv.py:
  // _BLOCKS_PER_SM); registers and shared memory allow no more
  static constexpr int MINB = CO == 64 ? 3 : 2;
  static_assert(NT == 2 * CO, "stage: a thread copies one quad of g");
};

// stage tile `tile` of tap row di and channels c0.. into xs, gs. A thread
// copies one channel quad of a fixed set of pixels, so the index arithmetic
// is done once per tile.
template <int CO>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ g,
                                      float* xs, float* gs, int tile, int di,
                                      int c0, int H, int W, int C,
                                      int tiles_h, int tiles_w) {
  constexpr int GS = Shape<CO>::GS;
  constexpr int NT = Shape<CO>::NT;
  const int b = tile / (tiles_h * tiles_w);
  const int rem = tile % (tiles_h * tiles_w);
  const int y0 = (rem / tiles_w) * TH;
  const int x0 = (rem % tiles_w) * TW;
  const long long img = (long long)b * H * W;
  {
    // x: the TH x XW halo, rows y0 + di - 1 .., columns x0 - 1 ..
    constexpr int PSTEP = NT / (KC / 4);
    const int q4 = threadIdx.x % (KC / 4);
    const int p0 = threadIdx.x / (KC / 4);
#pragma unroll
    for (int k = 0; k < (TH * XW + PSTEP - 1) / PSTEP; ++k) {
      const int p = p0 + k * PSTEP;
      if (p < TH * XW) {
        const int gy = y0 + di - 1 + p / XW;
        const int gx = x0 - 1 + p % XW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float* src =
            ok ? x + (img + (long long)gy * W + gx) * C + c0 + 4 * q4 : x;
        tf32x3::cp_async16(xs + p * XS + 4 * q4, src, ok ? 16 : 0);
      }
    }
  }
  {
    // g: NT = 2 CO threads, so a thread takes one quad of pixels
    // p0, p0 + 8, ..: tile row k / (TW/8), column p0 + 8 (k % (TW/8))
    const int q4 = threadIdx.x % (CO / 4);
    const int p0 = threadIdx.x / (CO / 4);   // 0..7
    const float* src0 = g + (img + (long long)y0 * W + x0 + p0) * CO + 4 * q4;
    float* dst0 = gs + p0 * GS + 4 * q4;
#pragma unroll
    for (int k = 0; k < TP / 8; ++k) {
      const int r = k / (TW / 8), dx = 8 * (k % (TW / 8));
      const bool ok = y0 + r < H && x0 + p0 + dx < W;
      const float* src = ok ? src0 + (r * W + dx) * CO : g;
      tf32x3::cp_async16(dst0 + 8 * k * GS, src, ok ? 16 : 0);
    }
  }
}

template <int CO>
__global__ void __launch_bounds__(Shape<CO>::NT, Shape<CO>::MINB)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ part, int H, int W, int C, int tiles_h,
          int tiles_w, int ntiles) {
  constexpr int GS = Shape<CO>::GS;
  constexpr int STAGE = Shape<CO>::STAGE;
  extern __shared__ __align__(16) float smem[];   // 2 x [x tile, g tile]

  const int nchunk = C / KC;
  const int di = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * KC;
  const int split = blockIdx.y;
  const int t_begin = (int)((long long)ntiles * split / gridDim.y);
  const int t_end = (int)((long long)ntiles * (split + 1) / gridDim.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1;           // rows 48 wm .. 48 wm + 47 of dW
  const int n0 = (warp >> 1) * 32;   // its 32 output channels

  // m16 tile i of this warp: dj = mt / 2, channels (mt % 2) * 16 ..
  int xoff[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = wm * 3 + i;
    xoff[i] = (tig + (mt >> 1)) * XS + (mt & 1) * 16 + gid;
  }
  const int goff = tig * GS + n0 + gid;

  float acc[3][4][4], tot[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  if (t_begin < t_end)
    stage<CO>(x, g, smem, smem + XST, t_begin, di, c0, H, W, C, tiles_h,
              tiles_w);
  tf32x3::cp_async_commit();
  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    if (tile + 1 < t_end) {
      float* nxt = smem + (buf ^ 1) * STAGE;
      stage<CO>(x, g, nxt, nxt + XST, tile + 1, di, c0, H, W, C, tiles_h,
                tiles_w);
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();   // this tile's copies have landed
    __syncthreads();
    const float* xs = smem + buf * STAGE;
    const float* gs = xs + XST;
#pragma unroll 2
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int r = ks / (TW / 8);
      const int px0 = (ks % (TW / 8)) * 8;
      // B: g at pixels px0 + tig (+4) of row r, channels n0 + 8j + gid
      const float* gp = gs + (r * TW + px0) * GS + goff;
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j].set(gp[8 * j], gp[4 * GS + 8 * j]);
      // A: x at halo columns px0 + tig + dj (+4) of row r, channels
      // gid (+8) of the m-tile's 16
      const float* xp = xs + (r * XW + px0) * XS;
      FragA fa[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* a = xp + xoff[i];
        fa[i].set({a[0], a[8], a[4 * XS], a[4 * XS + 8]});
      }
      tf32x3::mma_tf32x3(acc, fa, fb);
    }
    tf32x3::fold(tot, acc);
    __syncthreads();   // the buffer is consumed before it is refilled
    buf ^= 1;
  }

  // the block's partial: part[split][di*3 + dj][c0 + row][co]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = wm * 3 + i;
    const int dj = mt >> 1;
    const int row = c0 + (mt & 1) * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = part +
                   (((long long)split * 9 + di * 3 + dj) * C + row) * CO +
                   n0 + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(dst) =
          make_float2(tot[i][j][0], tot[i][j][1]);
      *reinterpret_cast<float2*>(dst + 8 * CO) =
          make_float2(tot[i][j][2], tot[i][j][3]);
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
  const int set = tf32x3::allow_smem((const void*)dw_kernel<CO>,
                                     Shape<CO>::SMEM);
  if (set) return set;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  if (ntiles > 0x7fffffffLL || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  dw_kernel<CO><<<dim3(3 * (C / KC), nsplit), Shape<CO>::NT,
                  Shape<CO>::SMEM, stream>>>(x, g, part, H, W, C, tiles_h,
                                             tiles_w, (int)ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * CO;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, nsplit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 form: the float32 form's grid and warps (2 (M) x CO/32 (N), each
// 48 rows of dW (three m16 tiles: one dj and 16 channels each) by 32
// output channels (four n8 tiles)), on 2 x 32-pixel tiles of bf16.
namespace bfd {

using bf16 = __nv_bfloat16;

constexpr int TH = 2;              // pixel rows per tile
constexpr int TW = 32;             // pixel columns per tile
constexpr int TP = TH * TW;        // pixels per tile
constexpr int KSTEPS = TP / 16;    // k-steps (16 pixels of one row) a tile
constexpr int XW = TW + 2;         // halo columns
constexpr int XSB = KC * 2 + 16;   // bytes per staged x pixel (5 units)
constexpr int XSTB = TH * XW * XSB;  // bytes of one staged x tile

template <int CO>
struct Shape {
  static constexpr int GSB = CO * 2 + 16;    // bytes per staged g pixel
  static constexpr int STAGE = XSTB + TP * GSB;
  static constexpr int SMEM = 2 * STAGE;
  static constexpr int WN = CO / 32;         // warps along N
  static constexpr int NT = 32 * 2 * WN;     // threads: 128 or 192
  static constexpr int MINB = CO == 64 ? 3 : 2;   // as the float32 form's
  static_assert(NT == 2 * CO && TP % 16 == 0, "stage: 16 pixels a round");
  static_assert(XSTB % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
};

// stage tile `tile` of tap row di and channels c0.. into xs, gs (bytes):
// x's TH x XW halo (zeros outside the image) and g's TH x TW tile (zeros
// past the image), in 16-byte copies
template <int CO>
__device__ __forceinline__ void stage(const bf16* __restrict__ x,
                                      const bf16* __restrict__ g, char* xs,
                                      char* gs, int tile, int di, int c0,
                                      int H, int W, int C, int tiles_h,
                                      int tiles_w) {
  constexpr int GSB = Shape<CO>::GSB;
  constexpr int NT = Shape<CO>::NT;
  const int b = tile / (tiles_h * tiles_w);
  const int rem = tile % (tiles_h * tiles_w);
  const int y0 = (rem / tiles_w) * TH;
  const int x0 = (rem % tiles_w) * TW;
  const long long img = (long long)b * H * W;
  {
    constexpr int UP = KC / 8;           // units of a pixel's chunk
    constexpr int PSTEP = NT / UP;
    const int u = threadIdx.x % UP;
    const int p0 = threadIdx.x / UP;
#pragma unroll
    for (int k = 0; k < (TH * XW + PSTEP - 1) / PSTEP; ++k) {
      const int p = p0 + k * PSTEP;
      if (p < TH * XW) {
        const int gy = y0 + di - 1 + p / XW;
        const int gx = x0 - 1 + p % XW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const bf16* src =
            ok ? x + (img + (long long)gy * W + gx) * C + c0 + 8 * u : x;
        tf32x3::cp_async16(xs + p * XSB + 16 * u, src, ok ? 16 : 0);
      }
    }
  }
  {
    // NT = 2 CO threads, CO / 8 units a pixel: 16 pixels a round
    constexpr int UP = CO / 8;
    const int u = threadIdx.x % UP;
    const int p0 = threadIdx.x / UP;   // 0..15
#pragma unroll
    for (int k = 0; k < TP / 16; ++k) {
      const int p = p0 + 16 * k;
      const int r = p / TW, col = p % TW;
      const bool ok = y0 + r < H && x0 + col < W;
      const bf16* src =
          ok ? g + (img + (long long)(y0 + r) * W + x0 + col) * CO + 8 * u
             : g;
      tf32x3::cp_async16(gs + p * GSB + 16 * u, src, ok ? 16 : 0);
    }
  }
}

template <int CO>
__global__ void __launch_bounds__(Shape<CO>::NT, Shape<CO>::MINB)
dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               float* __restrict__ part, int H, int W, int C, int tiles_h,
               int tiles_w, int ntiles) {
  constexpr int GSB = Shape<CO>::GSB;
  constexpr int STAGE = Shape<CO>::STAGE;
  extern __shared__ __align__(16) char smem_b[];   // 2 x [x tile, g tile]

  const int nchunk = C / KC;
  const int di = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * KC;
  const int split = blockIdx.y;
  const int t_begin = (int)((long long)ntiles * split / gridDim.y);
  const int t_end = (int)((long long)ntiles * (split + 1) / gridDim.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1;           // rows 48 wm .. 48 wm + 47 of dW
  const int n0 = (warp >> 1) * 32;   // its 32 output channels
  // ldmatrix rows: lane i gives row i % 8 of matrix q = i / 8
  const int q = lane >> 3, rr = lane & 7;

  // A (m16 tile i: dj = mt / 2, channels 16 (mt % 2) ..): matrix q is
  // pixels 8 (q / 2) .. of the k-step, shifted by dj, channels 8 (q % 2) ..
  // of the m-tile's 16: a[0..3] as mma_bf16 takes them
  int aoff[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = wm * 3 + i;
    aoff[i] = (rr + 8 * (q >> 1) + (mt >> 1)) * XSB +
              ((mt & 1) * 16 + 8 * (q & 1)) * 2;
  }
  // B (n8 tiles 2 jp and 2 jp + 1): matrix q is pixels 8 (q % 2) .. of the
  // k-step, output channels n0 + 16 jp + 8 (q / 2) ..: b0, b1 of tile 2 jp,
  // then of tile 2 jp + 1
  int boff[2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
    boff[jp] = (rr + 8 * (q & 1)) * GSB + (n0 + 16 * jp + 8 * (q >> 1)) * 2;

  float acc[3][4][4], tot[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  if (t_begin < t_end)
    stage<CO>(x, g, smem_b, smem_b + XSTB, t_begin, di, c0, H, W, C,
              tiles_h, tiles_w);
  tf32x3::cp_async_commit();
  int buf = 0;
  const uint32_t base = bf16mma::smem_addr(smem_b);
  for (int tile = t_begin; tile < t_end; ++tile) {
    if (tile + 1 < t_end) {
      char* nxt = smem_b + (buf ^ 1) * STAGE;
      stage<CO>(x, g, nxt, nxt + XSTB, tile + 1, di, c0, H, W, C, tiles_h,
                tiles_w);
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();   // this tile's copies have landed
    __syncthreads();
    const uint32_t xs = base + buf * STAGE;
    const uint32_t gs = xs + XSTB;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int r = ks / (TW / 16);
      const int px0 = (ks % (TW / 16)) * 16;
      uint32_t a[3][4], bq[2][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        bf16mma::ldmatrix_x4_trans(a[i], xs + (r * XW + px0) * XSB + aoff[i]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        bf16mma::ldmatrix_x4_trans(bq[jp],
                                   gs + (r * TW + px0) * GSB + boff[jp]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          bf16mma::mma_bf16(acc[i][2 * jp], a[i], bq[jp][0], bq[jp][1]);
          bf16mma::mma_bf16(acc[i][2 * jp + 1], a[i], bq[jp][2], bq[jp][3]);
        }
    }
    tf32x3::fold(tot, acc);
    __syncthreads();   // the buffer is consumed before it is refilled
    buf ^= 1;
  }

  // the block's partial, as the float32 form writes it
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = wm * 3 + i;
    const int dj = mt >> 1;
    const int row = c0 + (mt & 1) * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = part +
                   (((long long)split * 9 + di * 3 + dj) * C + row) * CO +
                   n0 + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(dst) =
          make_float2(tot[i][j][0], tot[i][j][1]);
      *reinterpret_cast<float2*>(dst + 8 * CO) =
          make_float2(tot[i][j][2], tot[i][j][3]);
    }
  }
}

// dw[i] = bf16(float(sum over the nsplit partials part[s][i], in double,
// s in order))
__global__ void dw_reduce_bf16_kernel(const float* __restrict__ part,
                                      bf16* __restrict__ dw, int n,
                                      int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double sum = 0.0;
  for (int s = 0; s < nsplit; ++s) sum += (double)part[(long long)s * n + i];
  dw[i] = __float2bfloat16_rn((float)sum);
}

template <int CO>
int launch(const bf16* x, const bf16* g, float* part, bf16* dw, int B, int H,
           int W, int C, int nsplit, cudaStream_t stream) {
  const int set = tf32x3::allow_smem((const void*)dw_bf16_kernel<CO>,
                                     Shape<CO>::SMEM);
  if (set) return set;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  if (ntiles > 0x7fffffffLL || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  dw_bf16_kernel<CO><<<dim3(3 * (C / KC), nsplit), Shape<CO>::NT,
                       Shape<CO>::SMEM, stream>>>(x, g, part, H, W, C,
                                                  tiles_h, tiles_w,
                                                  (int)ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * CO;
  dw_reduce_bf16_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n,
                                                              nsplit);
  return (int)cudaGetLastError();
}

}  // namespace bfd

}  // namespace

// x [B,H,W,C], g [B,H,W,Co], dw [3,3,C,Co]: float32, contiguous, 16-byte
// aligned; part: scratch of nsplit * 9 * C * Co floats. C a multiple of 32,
// Co 64 or 96 (RAFT's routed sites); nsplit >= 1 blocks share the pixels of
// each (tap row, channel chunk).
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

// The bf16 form: x [B,H,W,C], g [B,H,W,Co] and dw [3,3,C,Co] bf16,
// contiguous, 16-byte aligned; part: float32 scratch of nsplit * 9 * C * Co
// floats; the same shapes as conv2d_dw.
extern "C" int conv2d_dw_bf16(const void* x, const void* g, float* part,
                              void* dw, int B, int H, int W, int C, int Co,
                              int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % KC || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using bfd::bf16;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* out = static_cast<bf16*>(dw);
  switch (Co) {
    case 64: return bfd::launch<64>(xb, gb, part, out, B, H, W, C, nsplit, st);
    case 96: return bfd::launch<96>(xb, gb, part, out, B, H, W, C, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
