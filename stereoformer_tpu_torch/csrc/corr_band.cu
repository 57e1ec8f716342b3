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
// The bf16 form (corr_band_forward_bf16, namespace bfc): L, R and the
// volume bf16, as ops/cost_volume.py::correlation_volume_matmul computes
// them in bf16: the products (exact in float32) summed in float32, scaled
// by 1/C, rounded to bf16 once on the store. What bounds it: the same bytes,
// half as many (2*B*H*W*C*2 in, B*H*W*D*2 out: 22.1 us at LowCNN's eval
// shape, C = 256, D = 24, at the H100 SXM's 3.35 TB/s). Its multiply-adds
// (C an output, 1.7 G at D = 96) take the float32 form's design twice that
// bound on the CUDA cores, so they run on the bf16 tensor cores, as the
// TPU kernel's L.R^T runs on its matrix unit:
// - A warp takes 16 pixels w0 .. w0+15 and a span of up to 128
//   disparities, and forms S = L.R^T over the 16 + span - 1 R pixels its
//   band needs (rounded up to NT n8 tiles) with mma.sync m16n8k16 (bf16 in,
//   float32 accumulators, csrc/bf16mma.cuh): A by ldmatrix.x4 from the
//   staged L rows, B by ldmatrix.x4 from the staged R rows as they lie (an
//   R row is a column of B). That is 1.7x the band's products at D = 24,
//   1.2x at D = 96: a few GFLOP, far under the tensor cores' rate.
// - Its band, out[w][d] = S[w][w - d], goes from the accumulators into a
//   [16, span] bf16 tile of the warp's in shared memory (times 1/C rounded
//   to float32, which is S / C at a C that is a power of two, then rounded
//   to bf16 once; a division's slow path stalled the warp at every zero),
//   which the warp writes out as 16-byte stores (a tile of consecutive
//   pixels with all of D is contiguous), or bf16 by bf16 when D % 8 != 0.
//   The tiles take the ring slot of the task's last stage, after a barrier.
// - A block is 1, 2, 4 or 8 such warps side by side (a tile of 16 to 128
//   pixels, one R slab for all of them) and is persistent: its tasks
//   (b, h, tile, span) are blockIdx.x, + gridDim.x, ...; the host plan
//   (ops/cost_volume.py::corr_bf16_plan) picks the width and a grid of at
//   most one wave of resident blocks, at least two an SM. Channels are
//   staged KC = 64 at a time, each pixel's whole 128-byte line (16-byte
//   chunks XOR-ed with row % 8, so ldmatrix's 8 rows hit 8 bank groups), by
//   cp.async in a ring of 3 stages (2 for a band past 8 n8 tiles, whose
//   heavier compute wants more blocks on the SM) that runs across task
//   boundaries: the next task's first chunks land while this one computes
//   and writes its band. Rows outside the image are zero-filled, which
//   makes every w < d output exactly 0; a C that is not a multiple of 16
//   has its last k16 step half zero-filled.
// - Measured (scripts/corr_bf16_probe.py, H100 80GB HBM3 at 700 W): half
//   lines (KC = 32) stage 20-30% slower; the staging alone, nothing
//   computed, takes ~80% of the kernel's time at D = 24.
// - One truncating tensor-core add per k16 step, C / 16 of them an output
//   (16 at C = 256), no fold: within one bf16 ulp of float32 sums
//   (tests/test_torch_corr_bf16.py emulates it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16mma.cuh"

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

// float offset of 16-byte chunk q (4 channels) of staged row r
__device__ __forceinline__ int slot(int r, int q) {
  return r * CK + ((q ^ ((r >> 2) & 7)) << 2);
}

// floats of one stage for a span of `span` disparities: L tile, R slab
__host__ __device__ inline int stage_floats(int span) {
  return (TW + TW + span - 1) * CK;
}

__global__ void __launch_bounds__(32 * NW)
corr_band_kernel(const float* __restrict__ left,
                 const float* __restrict__ right, float* __restrict__ out,
                 int W, int C, int D, int tiles) {
  constexpr int CKT = CK;   // channels per stage
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (blockDim.x >> 5) * DT;   // disparities of the block
  const int rlen = TW + span - 1;            // R slab rows
  const int stage = stage_floats(span);

  const int w0 = (blockIdx.x % tiles) * TW;
  const int dspan = (blockIdx.x / tiles) * span;   // the span's first d
  const long long row = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * W;
  const float* lrow = left + row * C;
  const float* rrow = right + row * C;
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
      const int c = c0 + 4 * q;
      const bool ok = w >= 0 && w < W && c < C;
      const float* base = is_l ? lrow : rrow;
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
      for (int a = 0; a < WT; ++a)
#pragma unroll
        for (int b = 0; b < DT; ++b) {
          const float4 x = l[a];
          const float4 y = r[a - b + DT - 1];
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
  float* o = out + (row + w) * D + d0;
  if (d0 + DT <= D && (D & 3) == 0) {
    reinterpret_cast<float4*>(o)[0] =
        make_float4(res[0] / fc, res[1] / fc, res[2] / fc, res[3] / fc);
    reinterpret_cast<float4*>(o)[1] =
        make_float4(res[4] / fc, res[5] / fc, res[6] / fc, res[7] / fc);
    return;
  }
#pragma unroll
  for (int b = 0; b < DT; ++b)
    if (d0 + b < D) o[b] = res[b] / fc;
}

int launch(const float* left, const float* right, float* out, int B, int H,
           int W, int C, int D, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 != 0 || D <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int warps = min(NW, (D + DT - 1) / DT);
  const int span = warps * DT;
  const long long tiles = (W + TW - 1) / TW;
  const long long blocks = tiles * ((D + span - 1) / span);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NST * stage_floats(span) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks, H, B);
  corr_band_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      left, right, out, W, C, D, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 form. ops/cost_volume.py keeps a copy of its geometry
// (BF16_KC, BF16_STAGES, BF16_NT, BF16_MAX_SPAN, corr_bf16_smem) to plan
// the grid (corr_bf16_plan).
namespace bfc {

using bf16 = __nv_bfloat16;
constexpr int KC = 64;           // channels a stage: 128-byte rows
constexpr int PIECES = KC / 8;   // 16-byte pieces a staged row
// the swizzle: staged rows a 128-byte line, and the pieces' XOR mask
constexpr int LINE_ROWS = PIECES < 8 ? 8 / PIECES : 1;
constexpr int SWIZZLE = PIECES < 8 ? PIECES - 1 : 7;
constexpr int MAX_WARPS = 8;     // warps a block, 16 pixels each
constexpr int MAX_SPAN = 128;    // disparities a warp, when D is split

// the most disparities a warp's NT n8 tiles hold: its 16 pixels need
// 16 + span - 1 R columns
__host__ __device__ constexpr int span_max(int nt) { return 8 * nt - 15; }

// stages in the ring: 3 while a warp's band is at most 8 n8 tiles, 2 past
// that, so that a third block fits on the SM beside the heavier band
__host__ __device__ constexpr int stages(int nt) { return nt <= 8 ? 3 : 2; }

// R slab rows of a block of `nw` warps: warp g reads rows 16 g ..
// 16 g + 8 NT - 1, NT rounded up to even (ldmatrix.x4 loads n8 tiles in
// pairs)
__host__ __device__ constexpr int slab_rows(int nw, int nt) {
  return 16 * (nw - 1) + 8 * (nt + (nt & 1));
}

// bf16 elements of one stage: the L tile, then the R slab
__host__ __device__ constexpr int stage_elems(int nw, int nt) {
  return (16 * nw + slab_rows(nw, nt)) * KC;
}

// a row of a warp's band tile: the span rounded up to 8, and to an odd
// multiple of 8, so that the 8 rows a store reaches start 16 bytes
// apart modulo 32 banks (rows of 16 B-lines would share banks)
__host__ __device__ constexpr int span_pad(int span) {
  return ((span + 7) & ~7) | 8;
}

// the ring; the warps' [16, span] band tiles take the slot of a task's
// last stage (launch_nt checks that they fit one)
__host__ __device__ constexpr int smem_bytes(int nw, int nt) {
  return stages(nt) * stage_elems(nw, nt) * 2;
}

// element offset of 16-byte piece q of staged row r: the pieces XOR-ed
// with the row's line (two 64-byte rows a 128-byte line at KC = 32), so
// the 8 rows an ldmatrix reads (8 consecutive rows, one piece) lie in 8
// bank groups
__device__ __forceinline__ int slot(int r, int q) {
  return r * KC + ((q ^ ((r / LINE_ROWS) & SWIZZLE)) << 3);
}

template <int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
corr_band_bf16_kernel(const bf16* __restrict__ left,
                      const bf16* __restrict__ right, bf16* __restrict__ out,
                      int W, int C, int D, int span, int tiles, int spans,
                      int tasks) {
  constexpr int NTL = NT + (NT & 1);
  constexpr int NST = stages(NT);
  extern __shared__ uint4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int nw = blockDim.x >> 5;
  const int tw = 16 * nw;                  // pixels a task
  const int stage = stage_elems(nw, NT);
  const int nslab = slab_rows(nw, NT);
  const int spad = span_pad(span);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = (C + KC - 1) / KC;        // stages a task
  // 1/C rounded to float32: the band is bf16(S * rc), exactly S / C where
  // C is a power of two; a division's slow path (a zero S, every w < d)
  // would stall the warp
  const float rc = 1.f / (float)C;
  const int mine = (tasks - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;         // this block's tasks
  const int total = mine * nk;

  // the block's task i: image row (b * H + h), first pixel, first d. The
  // tiles of a row are rotated by the row, so the tasks an SM gets (every
  // gridDim.x-th) are not all one edge tile.
  auto task = [&](int i, long long& row, int& w0, int& dspan) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    const int per_row = tiles * spans;
    row = t / per_row;
    const int rem = t % per_row;
    w0 = (int)((rem / spans + row) % tiles) * tw;
    dspan = (rem % spans) * span;
  };

  // stage s of the block's stream: chunk s % nk of task s / nk, into ring
  // slot s % NST. R slab row 0 is pixel w0 - dspan - (span - 1); rows past
  // the 16 nw + span - 1 the band reads, and rows outside the image, are
  // zero-filled.
  auto load = [&](int s) {
    long long row;
    int w0, dspan;
    task(s / nk, row, w0, dspan);
    const int c0 = (s % nk) * KC;
    bf16* st = smem + (s % NST) * stage;
    const bf16* lrow = left + row * W * C;
    const bf16* rrow = right + row * W * C;
    const int rbase = w0 - dspan - (span - 1);
    const int rneed = tw + span - 1;
    for (int n = tid; n < (tw + nslab) * PIECES; n += blockDim.x) {
      const int r = n / PIECES, q = n % PIECES;
      const bool is_l = r < tw;
      const int rr = is_l ? r : r - tw;
      const int w = is_l ? w0 + rr : rbase + rr;
      const int c = c0 + 8 * q;
      const bool ok = w >= 0 && w < W && c < C && (is_l || rr < rneed);
      const bf16* base = is_l ? lrow : rrow;
      cp_async16(st + (is_l ? 0 : tw * KC) + slot(rr, q),
                 ok ? base + (long long)w * C + c : base, ok ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the band of the block's task i from the accumulators into the warp's
  // tile `band`, then out: lane (g, t) holds S[m][n] for m = g, g + 8 and
  // n = 8 j + 2 t, + 1 (bf16mma.cuh), pixel w0 + 16 warp + m against R
  // pixel w0 + 16 warp - dspan - (span - 1) + n, so d - dspan = m - n +
  // span - 1
  auto epilogue = [&](int i, bf16* band) {
    long long row;
    int w0, dspan;
    task(i, row, w0, dspan);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1);
        const int dr = m - (8 * j + 2 * t + (e & 1)) + span - 1;
        if (dr >= 0 && dr < span)
          band[m * spad + dr] = __float2bfloat16_rn(acc[j][e] * rc);
      }
    __syncwarp();
    const int wb = w0 + 16 * warp;
    const int npx = min(16, W - wb);
    const int sv = min(span, D - dspan);   // the span's outputs within D
    bf16* o = out + (row * W + wb) * D + dspan;
    if ((D & 7) == 0) {
      const int nch = sv >> 3;
      for (int x = lane; x < npx * nch; x += 32) {
        const int p = x / nch, q = x % nch;
        *reinterpret_cast<uint4*>(o + (long long)p * D + 8 * q) =
            *reinterpret_cast<const uint4*>(band + p * spad + 8 * q);
      }
    } else {
      for (int x = lane; x < npx * sv; x += 32) {
        const int p = x / sv, e = x % sv;
        o[(long long)p * D + e] = band[p * spad + e];
      }
    }
    __syncwarp();
  };

  // ldmatrix rows: A, the warp's 16 L rows, pieces 2 ks, 2 ks + 1 (lanes
  // 0-15, 16-31); B, n8 tiles j, j + 1 of the warp's R rows, pieces 2 ks,
  // 2 ks + 1 (lanes by (lane / 8) % 2)
  const int arow = 16 * warp + (lane & 15), apiece = lane >> 4;
  const int brow = 16 * warp + 8 * (lane >> 4) + (lane & 7);
  const int bpiece = (lane >> 3) & 1;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<NST - 2>();   // stage s has landed
    __syncthreads();            // ... for every thread; stage s - 1 is done
    if (s + NST - 1 < total) load(s + NST - 1);
    cp_async_commit();
    const int k = s % nk;
    bf16* ls = smem + (s % NST) * stage;
    const bf16* rs = ls + tw * KC;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (k * KC + 16 * ks >= C) break;   // past C (C % 16 == 8)
      uint32_t a[4];
      bf16mma::ldmatrix_x4(
          a, bf16mma::smem_addr(ls + slot(arow, 2 * ks + apiece)));
#pragma unroll
      for (int j = 0; j < NTL; j += 2) {
        uint32_t b[4];
        bf16mma::ldmatrix_x4(
            b, bf16mma::smem_addr(rs + slot(brow + 8 * j, 2 * ks + bpiece)));
        bf16mma::mma_bf16(acc[j], a, b[0], b[1]);
        if (j + 1 < NT) bf16mma::mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    if (k == nk - 1) {
      // every warp is done with this stage: its slot takes the bands (the
      // slot is staged into again after the next iteration's barrier)
      __syncthreads();
      epilogue(s / nk, ls + warp * 16 * spad);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
  }
}

// args: W, C, D, warps, span, tiles, spans, tasks, blocks
template <int NT>
int launch_nt(const bf16* left, const bf16* right, bf16* out,
              const int (&args)[9], void* stream) {
  const int W = args[0], C = args[1], D = args[2], warps = args[3],
            span = args[4], tiles = args[5], spans = args[6],
            tasks = args[7], blocks = args[8];
  const int smem = smem_bytes(warps, NT);
  if (warps * 16 * span_pad(span) > stage_elems(warps, NT))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_band_bf16_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  corr_band_bf16_kernel<NT>
      <<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
          left, right, out, W, C, D, span, tiles, spans, tasks);
  return (int)cudaGetLastError();
}

int launch(const bf16* left, const bf16* right, bf16* out, int B, int H,
           int W, int C, int D, int warps, int span, int blocks,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || D <= 0 ||
      warps < 1 || warps > MAX_WARPS || span < 1 || span > span_max(18))
    return (int)cudaErrorInvalidValue;
  const long long spans = (D + span - 1) / span;
  if (spans > 1 && (span % 8 != 0 || span > MAX_SPAN))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (W + 16 * warps - 1) / (16 * warps);
  const long long tasks = (long long)B * H * tiles * spans;
  if (tasks > 0x7fffffffLL || blocks < 1 || blocks > tasks)
    return (int)cudaErrorInvalidValue;
  const int args[] = {W, C, D, warps, span, (int)tiles, (int)spans,
                      (int)tasks, blocks};
  if (span <= span_max(5)) return launch_nt<5>(left, right, out, args, stream);
  if (span <= span_max(8)) return launch_nt<8>(left, right, out, args, stream);
  if (span <= span_max(14))
    return launch_nt<14>(left, right, out, args, stream);
  return launch_nt<18>(left, right, out, args, stream);
}

}  // namespace bfc

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
// aligned; out bf16 [B, H, W, D]. The plan (ops/cost_volume.py::
// corr_bf16_plan): `warps` (1-8) a block, each 16 pixels of a tile;
// `span` disparities a task (D itself, or a multiple of 8 up to 128 when D
// is split); `blocks` persistent blocks, at most the tasks. Returns
// cudaErrorInvalidValue for what it does not take, else as
// corr_band_forward.
extern "C" int corr_band_forward_bf16(const void* left, const void* right,
                                      void* out, int B, int H, int W, int C,
                                      int D, int warps, int span, int blocks,
                                      void* stream) {
  return bfc::launch(static_cast<const bfc::bf16*>(left),
                     static_cast<const bfc::bf16*>(right),
                     static_cast<bfc::bf16*>(out), B, H, W, C, D, warps,
                     span, blocks, stream);
}
