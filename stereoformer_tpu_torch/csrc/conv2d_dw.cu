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
// M = 3 x 32 rows for a chunk of 32 input channels (zeros past C where C
// is no multiple of 32), N = Co, K = pixels, split over pixels. Block
// (di * ceil(C/32) + chunk, s) takes tap row di, the chunk's 32 channels,
// all Co outputs and the s-th of nsplit equal runs of
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
// `_dw`'s cast to the bf16 weight: the exact bf16 products summed in
// float32 and the result rounded once to bf16. What bounds it: at the site
// with the most work (x and g [8,320,720,64]) the same 136 GFLOP against
// 472 MB read, 0.141 ms at 3.35 TB/s and 0.137 ms at the card's 989 TFLOP/s
// of bf16: bytes and operations alike, so both the copies and the MMAs
// must run near their rates, and together.
// Design (namespace bfd). The Pallas kernel reads x and g once each and
// applies all nine taps in VMEM; this form does the same from shared
// memory. A block takes a slice of KC input channels (the last slice
// zero-filled past C by the maps) and all Co outputs,
// all nine taps, and walks strips of TW columns down runs of rows (the
// grid's splits share the rows of every strip of every image in equal
// runs; ops/dw_conv.py::dw_plan fills the card in whole waves). A ring of
// stages, three x rows (with the one-column halo on both sides) and the
// three g rows one below them, is staged by TMA (one thread issues a box
// per 32 channels; the maps fill the image edges and the halo with zeros,
// and write with 64-byte swizzle, so the ldmatrix rows hit distinct banks)
// and counted on an mbarrier a stage. Each staged x row serves the three
// tap rows that need it: x row r with g rows r + 1, r, r - 1 is taps
// di = 0, 1, 2, each dj a shift of the A fragment's pixels by one. Two
// mainloops, by Co:
//  - Co = 64 (WG 1): wgmma m64n64k16. Three warpgroups, one a tap column
//    dj, each warp 16 of the 64 channels: the A fragment (x, shifted by dj)
//    comes from ldmatrix into registers, B is g in shared memory (MN-major,
//    its two 32-channel boxes as the descriptor's two 32-column atoms), and
//    each x row's A meets three g rows (the previous stage's last two stay
//    in the ring) into acc[di], a 64 x 64 tile.
//  - Co = 96 (WG 0; 3 x 32 = 96 rows a tap row fit no 64-row wgmma tile):
//    mma.sync m16n8k16. A warp owns 16 channels by 24 outputs, all nine
//    taps; the B fragments of the last three g rows rotate through
//    registers, so a g row is read from shared memory once and an x
//    fragment feeds 3 x 3 MMAs.
// The tensor core's truncating sums are folded into float32 totals in
// shared memory every FOLD_K k-steps (tests/test_torch_tf32x3.py emulates
// the sum at RAFT's largest site: it holds the tolerance folded, not
// unfolded). Each block writes its partial of dw; the reduction sums the
// partials in double, in a fixed order, and rounds once to bf16 (through
// float32, as the float32 sum the Pallas kernel returns is rounded): two
// calls give the same bits. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 18, graph replay): 0.239, 0.129, 0.187, 0.101 ms at
// RAFT's four train sites ([8|4,320,720,64], [8|4,160,360,96]), 59, 55,
// 41, 38% of the bound and 0.86, 0.88, 1.006, 0.96 x cuDNN's bf16
// conv2d_weight; the earlier form (2 x 32-pixel tiles restaged for each
// tap row, 70% of its time staging) took 0.650, 0.335, 0.378, 0.200 ms.
// What holds it (scripts/dw_bf16_probe.py): the MMAs, at C = 96 on
// mma.sync (0.177 of 0.184 ms with nothing staged), at C = 64 wgmma (0.205
// of 0.238) over staging (0.184).

#include <cuda.h>
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
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W &&
                        c0 + 4 * q4 < C;
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

  const int nchunk = (C + KC - 1) / KC;
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

  // the block's partial: part[split][di*3 + dj][c0 + row][co], rows
  // below C
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
      if (row < C)
        *reinterpret_cast<float2*>(dst) =
            make_float2(tot[i][j][0], tot[i][j][1]);
      if (row + 8 < C)
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
  dw_kernel<CO><<<dim3(3 * ((C + KC - 1) / KC), nsplit), Shape<CO>::NT,
                  Shape<CO>::SMEM, stream>>>(x, g, part, H, W, C, tiles_h,
                                             tiles_w, (int)ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * CO;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, nsplit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 form (the note at the head of the file): a block takes KC input
// channels and all Co outputs, all nine taps, and walks strips of TW
// columns down runs of rows through a ring of x and g rows staged by TMA.
namespace bfd {

using bf16 = __nv_bfloat16;

// The tiling by Co: input channels a block (KC), strip width (TW, a
// multiple of 16), ring depth in stages (STAGES), resident blocks an SM
// (MINB), and the mainloop: WG 1, warpgroup MMAs (wgmma), one warpgroup a
// tap column dj, each warp 16 of the KC = 64 channels (WN8 = CO / 8); WG
// 0, warp MMAs (mma.sync), each warp 16 channels by WN8 n8 tiles of
// outputs. The values come as -D defines DW<CO>_<name> from the one table
// of them, kernels.py's DW_BF16_TILING, by which ops/dw_conv.py also plans
// the grid.
#if !defined(DW64_KC) || !defined(DW96_KC)
#error "build with the bf16 tiling's defines (kernels.py: nvcc_flags)"
#endif
template <int CO>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int KC = DW64_KC, WN8 = DW64_WN8, TW = DW64_TW,
                       STAGES = DW64_STAGES, MINB = DW64_MINB, WG = DW64_WG;
};
template <>
struct Cfg<96> {
  static constexpr int KC = DW96_KC, WN8 = DW96_WN8, TW = DW96_TW,
                       STAGES = DW96_STAGES, MINB = DW96_MINB, WG = DW96_WG;
};

constexpr int RS = 3;        // x rows a stage: the g fragments' rotation
constexpr int FOLD_K = 96;   // k-steps an accumulator takes between folds
// A TMA box is 32 channels (64-byte lines) of its rows and columns, written
// with 64-byte swizzle (the 16-byte chunk c of line L at chunk
// c ^ ((L >> 1) & 3), a pattern 512 bytes long) into a region aligned to
// 512 bytes
constexpr int LINE = 64;

constexpr int align512(int n) { return (n + 511) / 512 * 512; }

template <int CO>
struct Shape {
  static constexpr int KC = Cfg<CO>::KC, WN8 = Cfg<CO>::WN8;
  static constexpr int TW = Cfg<CO>::TW, STAGES = Cfg<CO>::STAGES;
  static constexpr int MINB = Cfg<CO>::MINB, WG = Cfg<CO>::WG;
  static constexpr int SEGS = TW / 16;          // k-steps a strip row
  static constexpr int WM = KC / 16;            // warps along channels
  static constexpr int WN = CO / (8 * WN8);     // warps along outputs
  static constexpr int NT = WG ? 3 * 128 : 32 * WM * WN;
  static constexpr int XW = TW + 2;             // halo columns
  static constexpr int NXR = KC / 32, NGR = CO / 32;   // boxes a stage
  static constexpr int XBOX = RS * XW * LINE;   // bytes of an x box
  static constexpr int GBOX = RS * TW * LINE;   // bytes of a g box
  static constexpr int XREG = align512(XBOX);   // its region's stride
  static constexpr int GREG = align512(GBOX);
  static constexpr int GOFF = NXR * XREG;       // the g boxes in a stage
  static constexpr int STAGE = GOFF + NGR * GREG;
  static constexpr int TX = NXR * XBOX + NGR * GBOX;   // bytes a stage
  // accumulators a thread, acc[A1][A2][4]: nine taps by WN8 n8 tiles
  // (WG 0), or three tap rows by the CO / 8 n8 tiles of a 64 x CO
  // warpgroup tile (WG 1)
  static constexpr int A1 = WG ? 3 : 9, A2 = WN8;
  static constexpr int NACC = A1 * A2 * 4;
  static constexpr int TOT = NACC * NT * 4;     // bytes of the totals
  static constexpr int RING = TOT + STAGES * STAGE;
  // the ring, then a full barrier and a word of g-row flags a stage, and
  // room to align the base to 1024 bytes
  static constexpr int SMEM = RING + STAGES * 16 + 1024;
  static constexpr int FOLD = FOLD_K / (RS * SEGS);   // stages a fold
  static_assert(TW % 16 == 0 && KC % 32 == 0 && CO % 32 == 0 &&
                    CO % (8 * WN8) == 0,
                "whole k-steps, boxes, m16 and n8 tiles");
  static_assert(!WG || (KC == 64 && CO == 8 * WN8 && TW == 16),
                "a warpgroup: 4 warps of 16 channels, all outputs, one "
                "k-step a row");
  static_assert(STAGES >= (WG ? 4 : 2) && FOLD >= 1 && TOT % 512 == 0,
                "a ring of 512-byte aligned boxes, a fold interval");
  static_assert(MINB * (SMEM + 1024) <= 233472 && SMEM <= 232448,
                "MINB blocks an SM in shared memory");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   bf16mma::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bf16mma::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of `bar` has completed; a stage that
// never lands (a box whose bytes the barrier does not expect) traps after
// some 2^26 polls (seconds) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = bf16mma::smem_addr(bar);
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    if (polls == (1 << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// the box of `map` at (c, w, h, b) to dst, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int w, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          bf16mma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b),
      "r"(bf16mma::smem_addr(bar))
      : "memory");
}

// The items are the rows of every strip of every image, (b, strip, h) with
// h fastest: nitems = B * nstrips * H. Block (slice, split) takes items
// [nitems * split / nsplit, nitems * (split + 1) / nsplit): runs of rows of
// one strip, each walked as x rows ha - 1 .. hb in stages of RS rows, the
// last stage padded. A stage is KC / 32 TMA boxes of x, rows r .. r + RS - 1
// of 32 channels from c0 + 32 i, columns x0 - 1 .. x0 + TW, and CO / 32 of
// g, rows r + 1 .. r + RS of channels 32 i .., columns x0 .. x0 + TW - 1:
// the maps fill zeros outside the tensors (the image edges, the halo), and
// a g row outside the run [ha, hb) is left out of the sums by the stage's
// flags (bit i: g row r - 1 + i is in the run).
template <int CO>
struct Walk {
  using S = Shape<CO>;
  int it, i1, H, nstrips, b, x0, ha, hb, r;

  __device__ Walk(int i0, int i1_, int H_, int nstrips_)
      : it(i0), i1(i1_), H(H_), nstrips(nstrips_), b(0), x0(0), ha(0),
        hb(0), r(0) {
    if (it < i1) next_run();
  }

  // the stages of items [i0, i1)
  __device__ static int stages(int i0, int i1, int H) {
    int n = 0;
    for (int i = i0; i < i1;) {
      const int rows = min(H - i % H, i1 - i);
      n += (rows + 2 + RS - 1) / RS;
      i += rows;
    }
    return n;
  }

  __device__ void next_run() {
    const int bs = it / H;
    ha = it % H;
    hb = min(H, ha + (i1 - it));
    b = bs / nstrips;
    x0 = (bs % nstrips) * S::TW;
    r = ha - 1;
    it += hb - ha;
  }

  // the next stage's boxes into dst, counted on bar, its flags in flag
  __device__ void issue(char* dst, uint64_t* bar, int* flag,
                        const CUtensorMap* xm, const CUtensorMap* gm,
                        int c0) {
    int f = 0;
#pragma unroll
    for (int i = 0; i < RS + 2; ++i)
      f |= (r - 1 + i >= ha && r - 1 + i < hb) << i;
    *flag = f;
    mbar_expect_tx(bar, S::TX);
    for (int i = 0; i < S::NXR; ++i)
      tma_load(dst + i * S::XREG, xm, bar, c0 + 32 * i, x0 - 1, r, b);
    for (int i = 0; i < S::NGR; ++i)
      tma_load(dst + S::GOFF + i * S::GREG, gm, bar, 32 * i, x0, r + 1, b);
    r += RS;
    if (r > hb && it < i1) next_run();
  }
};

// the shared address of 16-byte chunk c of line L of a box region
__device__ __forceinline__ uint32_t swz(uint32_t region, int L, int c) {
  return region + L * LINE + (((c ^ (L >> 1)) & 3) << 4);
}

// A lane's ldmatrix offsets in an x box region for lines L = v + aline,
// v = 0..7 (the swizzle depends on L % 8 = (v + aline) % 8): the k-steps
// of a stage start at lines k XW + 16 sg + dj, so the offset of line
// 8 m + v + aline is 512 m + off[v]
struct ALane {
  uint32_t off[8];
  __device__ ALane(uint32_t box, int aline, int chunk) {
#pragma unroll
    for (int v = 0; v < 8; ++v) off[v] = swz(box, v + aline, chunk);
  }
  // L0 a constant once the loops are unrolled
  __device__ __forceinline__ uint32_t at(int L0, uint32_t base) const {
    return base + (L0 >> 3) * 8 * LINE + off[L0 & 7];
  }
};

// The warp-MMA mainloop (WG 0): warp (wm, wn) owns channels c0 + 16 wm ..
// by outputs n0 = 8 WN8 wn .., all nine taps; per stage and k-step of x row
// r + k, B fragments of g row r + k + 1 join the last two rows' in a
// three-slot ring, and each dj's A fragment of x row r + k meets all
// three.
template <int CO>
__device__ __forceinline__ void mainloop_mma(
    float (&acc)[9][Shape<CO>::WN8][4],
    uint32_t (&bc)[Shape<CO>::SEGS][3][Shape<CO>::WN8][2], uint32_t xs,
    int f, const ALane& al, const uint32_t* bbox, const uint32_t* boff) {
  using S = Shape<CO>;
  constexpr int WN8 = S::WN8;
#pragma unroll
  for (int k = 0; k < RS; ++k) {   // step k: x row r + k
#pragma unroll
    for (int sg = 0; sg < S::SEGS; ++sg) {
      // g row r + k + 1, pixels 16 sg .. of the strip (lines k TW + 16 sg
      // .., a multiple of 8: the lane's offset does not change); zero
      // outside the run
      uint32_t (&bn)[WN8][2] = bc[sg][(k + 2) % 3];
      const uint32_t gl = (k * S::TW + sg * 16) * LINE;
#pragma unroll
      for (int jp = 0; jp < WN8 / 2; ++jp) {
        uint32_t v[4];
        bf16mma::ldmatrix_x4_trans(v, xs + bbox[jp] + gl + boff[jp]);
        bn[2 * jp][0] = v[0];
        bn[2 * jp][1] = v[1];
        bn[2 * jp + 1][0] = v[2];
        bn[2 * jp + 1][1] = v[3];
      }
      if constexpr (WN8 % 2)
        bf16mma::ldmatrix_x2_trans(
            bn[WN8 - 1], xs + bbox[WN8 / 2] + gl + boff[WN8 / 2]);
      if (!(f >> (k + 2) & 1))
#pragma unroll
        for (int j = 0; j < WN8; ++j) bn[j][0] = bn[j][1] = 0u;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        uint32_t a[4];
        bf16mma::ldmatrix_x4_trans(
            a, al.at(k * S::XW + sg * 16 + dj, xs));
        // tap di: output row r + k + 1 - di, whose g is in slot
        // (k + 2 - di) % 3
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int j = 0; j < WN8; ++j)
            bf16mma::mma_bf16(acc[3 * di + dj][j], a,
                              bc[sg][(k + 2 - di) % 3][j][0],
                              bc[sg][(k + 2 - di) % 3][j][1]);
      }
    }
  }
}

// The wgmma descriptor of a B tile at shared address addr, MN-major with
// 64-byte swizzle (mode 2): lbo bytes between its 32-column atoms along N
// (the g boxes), sbo between its 8-row groups along K
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         (uint64_t)((lbo & 0x3ffff) >> 4) << 16 |
         (uint64_t)((sbo & 0x3ffff) >> 4) << 32 | (uint64_t)2 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma, asynchronously: D (64 x 64, float32) += A (64 x 16 bf16, this
// warp's 16 rows as the m16n8k16 A fragment) B (16 x 64 bf16, `desc`,
// transposed: MN-major). d[j][e] is element e of n8 tile j, as an m16n8 C
// fragment of the warp's 16 rows
__device__ __forceinline__ void wgmma_64x64(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// The warpgroup mainloop (WG 1): warpgroup dj, warp w of it owns channels
// 16 w .. of all 64; per stage each x row r + k gives one A fragment
// (shifted by dj), which meets the B tiles of g rows r + k + 1 - di in
// shared memory (di = 0, 1, 2; rows r, r - 1 are the previous stage's last
// two, which the ring keeps) into acc[di]. The stage's MMAs run on while
// the next stage is waited for; they are waited for before the next
// stage's A fragments are loaded over theirs (so the ring keeps the two
// stages they read, and the one after).
template <int CO>
__device__ __forceinline__ void mainloop_wgmma(float (&acc)[3][8][4],
                                               uint32_t (&a)[RS][4],
                                               uint32_t xs, uint32_t xprev,
                                               int f, const ALane& al) {
  using S = Shape<CO>;
  wgmma_wait0();
  // the lane's lines carry dj (ALane)
#pragma unroll
  for (int k = 0; k < RS; ++k)
    bf16mma::ldmatrix_x4_trans(a[k], al.at(k * S::XW, xs));
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < RS; ++k)
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      // g row r + k + 1 - di: row k - di of this stage's (r + 1 ..), or
      // row k - di + RS of the previous one's
      const int row = k - di;
      const uint32_t g = row >= 0 ? xs + S::GOFF + row * S::TW * LINE
                                  : xprev + S::GOFF +
                                        (row + RS) * S::TW * LINE;
      if (f >> (k + 2 - di) & 1)
        wgmma_64x64(acc[di], a[k], gdesc(g, S::GREG, 8 * LINE));
    }
  wgmma_commit();
}

template <int CO>
__global__ void __launch_bounds__(Shape<CO>::NT, Shape<CO>::MINB)
dw_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap gmap,
               float* __restrict__ part, int H, int C, int nstrips,
               int nitems) {
  using S = Shape<CO>;
  constexpr int WN8 = S::WN8;
  // totals, the ring of stages, their barriers and g-row flags, from the
  // first 1024-byte boundary
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem_b = smem_raw + ((1024 - bf16mma::smem_addr(smem_raw) % 1024) %
                             1024);
  // this thread's totals, float4 e at tot[e * NT]: a warp's accesses are
  // 512 consecutive bytes
  float4* tot = reinterpret_cast<float4*>(smem_b) + threadIdx.x;
  char* ring = smem_b + S::TOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_b + S::RING);
  int* flags = reinterpret_cast<int*>(full + S::STAGES);

  const int c0 = blockIdx.x * S::KC;
  const int split = blockIdx.y;
  const int i0 = (int)((long long)nitems * split / gridDim.y);
  const int i1 = (int)((long long)nitems * (split + 1) / gridDim.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix rows: lane i gives row i % 8 of matrix q = i / 8. A (16
  // channels x 16 pixels, x at the pixels shifted by dj): matrix q is
  // pixels 8 (q / 2) .., channels 8 (q % 2) ..: a[0..3] as mma_bf16 and
  // wgmma take them
  const int q = lane >> 3, rr = lane & 7;
  // the warp's 16 channels of the block's KC, and (WG 0) its outputs or
  // (WG 1) its warpgroup's tap column
  const int wm = S::WG ? warp % 4 : warp % S::WM;
  const int n0 = S::WG ? 0 : (warp / S::WM) * 8 * WN8;
  const int dj = S::WG ? warp / 4 : 0;
  const int ach = 16 * wm + 8 * (q & 1);
  const ALane al((ach / 32) * S::XREG, rr + 8 * (q >> 1) + dj, ach % 32 / 8);
  // B (WG 0; 16 pixels x n8 tiles 2 jp, 2 jp + 1 of g): matrix q is pixels
  // 8 (q % 2) .., outputs n0 + 16 jp + 8 (q / 2) ..; an odd last tile is
  // read by ldmatrix.x2 (lanes 0-15: q / 2 = 0). The box of each, and the
  // lane's offset in its rows (line rr + 8 (q % 2) of a multiple of 8)
  uint32_t bbox[(WN8 + 1) / 2], boff[(WN8 + 1) / 2];
#pragma unroll
  for (int jp = 0; jp < (WN8 + 1) / 2; ++jp) {
    const int co = n0 + 16 * jp + 8 * (q >> 1);
    bbox[jp] = S::GOFF + (co / 32) * S::GREG;
    boff[jp] = swz(0, rr + 8 * (q & 1), co % 32 / 8);
  }

#pragma unroll
  for (int e = 0; e < S::NACC / 4; ++e)
    tot[e * S::NT] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nst = Walk<CO>::stages(i0, i1, H);
  // thread 0 stages ahead; WG 1 keeps the previous stage (its last g rows
  // are read) and the stage before it (read by MMAs still running), so it
  // stages two stages less ahead
  constexpr int AHEAD = S::STAGES - 1 - 2 * S::WG;
  Walk<CO> walk(i0, i1, H, nstrips);
  const CUtensorMap* xm = &xmap;
  const CUtensorMap* gm = &gmap;
  if (threadIdx.x == 0)
    for (int s = 0; s < AHEAD && s < nst; ++s)
      walk.issue(ring + s * S::STAGE, full + s, flags + s, xm, gm, c0);

  // WG 0: acc[3 di + dj][j], tap (di, dj), n8 tile j; bc, the ring of B
  // fragments (zero before the first row). WG 1: acc[di][j], n8 tile j of
  // the warpgroup's 64 x 64 tile of tap (di, dj)
  float acc[S::A1][S::A2][4];
#pragma unroll
  for (int t = 0; t < S::A1; ++t)
#pragma unroll
    for (int j = 0; j < S::A2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  uint32_t bc[S::SEGS][3][WN8][2];
  uint32_t awg[RS][4];   // WG 1: the stage's A fragments
#pragma unroll
  for (int sg = 0; sg < S::SEGS; ++sg)
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < WN8; ++j) bc[sg][s][j][0] = bc[sg][s][j][1] = 0u;

  const uint32_t base = bf16mma::smem_addr(ring);
  int slot = 0, ahead = AHEAD, since = 0;
  for (int t = 0; t < nst; ++t) {
    __syncthreads();   // the slot staged into next is consumed
    if (threadIdx.x == 0 && t + AHEAD < nst)
      walk.issue(ring + ahead * S::STAGE, full + ahead, flags + ahead, xm,
                 gm, c0);
    ahead = ahead + 1 == S::STAGES ? 0 : ahead + 1;
    mbar_wait(full + slot, (t / S::STAGES) & 1);   // stage t has landed
    const int f = flags[slot];
    const uint32_t xs = base + slot * S::STAGE;
    const uint32_t xprev =
        base + (slot == 0 ? S::STAGES - 1 : slot - 1) * S::STAGE;
    slot = slot + 1 == S::STAGES ? 0 : slot + 1;
    if constexpr (S::WG)
      mainloop_wgmma<CO>(acc, awg, xs, xprev, f, al);
    else
      mainloop_mma<CO>(acc, bc, xs, f, al, bbox, boff);
    if (++since == S::FOLD) {
      // the fragments' truncating sums into the float32 totals
      since = 0;
      if constexpr (S::WG) wgmma_wait0();
#pragma unroll
      for (int i = 0; i < S::A1; ++i)
#pragma unroll
        for (int j = 0; j < S::A2; ++j) {
          float4 v = tot[(i * S::A2 + j) * S::NT];
          v.x += acc[i][j][0];
          v.y += acc[i][j][1];
          v.z += acc[i][j][2];
          v.w += acc[i][j][3];
          tot[(i * S::A2 + j) * S::NT] = v;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        }
    }
  }

  if constexpr (S::WG) wgmma_wait0();
  // the block's partial, folded once more: part[split][tap][c][co], rows c
  // below C. Each acc[t][j] is an m16n8 C fragment (rows gid, gid + 8,
  // columns 2 tig, 2 tig + 1) of n8 tile j and tap 3 di + dj: t = 3 di + dj
  // (WG 0), di (WG 1)
#pragma unroll
  for (int t = 0; t < S::A1; ++t)
#pragma unroll
    for (int j = 0; j < S::A2; ++j) {
      const float4 v = tot[(t * S::A2 + j) * S::NT];
      const int tp = S::WG ? 3 * t + dj : t;
      const int row = c0 + 16 * wm + gid;
      float* dst = part + (((long long)split * 9 + tp) * C + row) * CO +
                   n0 + 8 * j + 2 * tig;
      if (row < C)
        *reinterpret_cast<float2*>(dst) =
            make_float2(v.x + acc[t][j][0], v.y + acc[t][j][1]);
      if (row + 8 < C)
        *reinterpret_cast<float2*>(dst + 8 * CO) =
            make_float2(v.z + acc[t][j][2], v.w + acc[t][j][3]);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A map of the bf16 NHWC tensor at `base` [B, H, W, C] whose boxes are 32
// channels x `w` columns x `h` rows of one image, zeros outside it, written
// with 64-byte swizzle (cuTensorMapEncodeTiled, found through the CUDA
// runtime's entry-point query: no library to link). Returns a
// cudaError_t.
inline int nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W,
                    int C, int w, int h) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const cuuint32_t box[4] = {LINE / 2, (cuuint32_t)w, (cuuint32_t)h, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int CO>
int launch(const bf16* x, const bf16* g, float* part, bf16* dw, int B, int H,
           int W, int C, int nsplit, cudaStream_t stream) {
  using S = Shape<CO>;
  const int set = tf32x3::allow_smem((const void*)dw_bf16_kernel<CO>,
                                     S::SMEM);
  if (set) return set;
  const int nstrips = (W + S::TW - 1) / S::TW;
  const long long nitems = (long long)B * nstrips * H;
  if (nitems > 0x7fffffffLL || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  int err = nhwc_map(&xmap, x, B, H, W, C, S::XW, RS);
  if (!err) err = nhwc_map(&gmap, g, B, H, W, CO, S::TW, RS);
  if (err) return err;
  dw_bf16_kernel<CO><<<dim3((C + S::KC - 1) / S::KC, nsplit), S::NT, S::SMEM,
                       stream>>>(
      xmap, gmap, part, H, C, nstrips, (int)nitems);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 9 * C * CO;
  dw_reduce_bf16_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n,
                                                              nsplit);
  return (int)cudaGetLastError();
}

}  // namespace bfd

}  // namespace

// x [B,H,W,C], g [B,H,W,Co], dw [3,3,C,Co]: float32, contiguous, 16-byte
// aligned; part: scratch of nsplit * 9 * C * Co floats. C a multiple of 8
// (the last 32-channel chunk zero-filled past C), Co 64 or 96 (the fused
// conv's output widths); nsplit >= 1 blocks share the pixels of each (tap
// row, channel chunk).
// Returns cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int conv2d_dw(const float* x, const float* g, float* part,
                         float* dw, int B, int H, int W, int C, int Co,
                         int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || nsplit <= 0)
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
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || nsplit <= 0)
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
