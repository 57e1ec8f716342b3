// Windowed modulated deformable convolution (DCNv2, stride 1, no bias) on
// Hopper (sm_90a), fused: x, offsets, mask and the weight in, out out.
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/deform_sample.py::_forward
// (body `_kernel`) together with the contraction G = x . W_k that the JAX
// package runs before it. For each output pixel p = (b, i, j) and output
// channel o,
//     out[p, o] = sum_k sum_c a_k[p, c] * W[k, c, o],
//     a_k[p, c] = m_k[p] * bilerp(x[b, :, :, c], i - pad + dil*ky + dy_k,
//                                               j - pad + dil*kx + dx_k)
// with (dy_k, dx_k) the offsets clamped to [-R, R] and samples outside the
// image read as zero (the Pallas kernel's zero-padded xpad). The TPU kernel
// contracts first and samples G_k = x . W_k; here each tap is sampled first
// and then contracted. Both orders compute the same linear function, and
// sampling first keeps the [B, H, W, K*Co] G (nine times x at K = 9,
// Co = C) out of device memory. The bilinear corner form gives the value
// of the Pallas kernel's (2R+2)^2 hat sum, since at most four of those hats
// are nonzero.
//
// What bounds it on the H100: at the learned bounds' shapes (C = Co = 16)
// the function's bound is its float32 arithmetic (4*K*C corner FMAs and
// K*C*Co contraction FMAs a pixel, 5.9 us at [8,72,120]) about as much as
// its bytes (x, offsets, mask and out once, 4.9 us). The kernel is bound by
// neither: its bilinear corners are read from shared memory, 4*K*C*4 bytes
// a pixel, and those reads (with their bank conflicts) and their latency
// set its time. So the contraction runs on the tensor cores as a 3xTF32
// product (csrc/tf32x3.cuh), float32-accurate and off the FMA pipe, and
// everything else a tap needs is kept out of shared memory.
//
// Design: one block per tile of `rows` output rows x 32 output columns and
// a chunk of up to 32 output channels (NT m16n8 tiles); a warp takes 32
// pixels of a row (MT = 2) or 16 (MT = 1, two warps a row, where the grid
// is too small to give each SM two warps a scheduler). Because the offsets
// are clamped, every corner that a tile can sample lies in a fixed halo of
// rows + dil*(k-1) + 2R + 1 rows and 32 + dil*(k-1) + 2R + 1 columns, which
// the block stages with cp.async, zeros outside the image (the Pallas
// kernel's zero-padded band). C is walked in chunks of 16 channels (each
// lane samples 4 consecutive channels with one 16-byte shared load a
// corner), and the outputs accumulate across chunks in registers. Per tap,
// each lane fetches the offsets and mask of one of its warp's pixels a tap
// ahead, clamps them, splits them into floor and fraction (the fraction
// taken from the offset itself, not from the absolute coordinate, so that
// no bits are lost to the pixel index) and folds the mask into the row
// weights; the lanes that sample that pixel take the entry by shuffles
// within their group of four. The warp then samples its pixels x 16
// channels straight into m16n8k8 A fragments, the channel order permuted so
// that a lane's four channels are its columns t and t+4 of two k-steps, and
// multiplies them by the tap's weight, staged as it lies in W and split
// into TF32 big and small parts as it is loaded. One tap's MMAs sum from
// zero and are folded into the float32 totals (the tensor core's sums
// truncate). The weight is staged for a group of taps at a time, so that
// any k fits. Where even a one-row tile's halo would not fit in shared
// memory (a very wide window or dilation), the same kernel reads the
// corners from x in device memory instead (HALO = false). The C entry
// chooses the tiling from the shapes and the card's SMs (`choose`). No
// atomics: a second
// call gives the same bits. The backward is autograd of the plain windowed
// form, as the Pallas kernel's VJP is.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int TW = 32;   // output columns of a tile
constexpr int CH = 16;   // channels of a chunk: 4 lanes x 4 channels
constexpr int SMEM_MAX = 232448;   // the H100's shared memory a block can take
constexpr int CO_BLOCK = 32;       // output channels of a block, at most
constexpr int W_BUDGET = 49152;    // bytes of weight staged at a time, at most
// below this many warps on the busiest SM (two a scheduler) a warp takes 16
// pixels instead of 32: twice the warps to hide each one's latency
constexpr int MIN_WARPS_PER_SM = 8;
// where the busiest SM still has room, the taps are split into up to
// MAX_SLICES slices, a warp each, while it runs at most SLICE_WARPS warps
constexpr int MAX_SLICES = 3, SLICE_WARPS = 24;

struct Geom {
  int B, H, W, C, Co, k, pad, dil, R, Ho, Wo, rows, HH, WW, kg, ts;
};

// the most threads a block of deform_fused_kernel<NT, *, MT> may have:
// where NT <= 2, at most 85 registers (MT = 2) or 64 (MT = 1) a thread
__host__ __device__ constexpr int max_threads(int nt, int mt) {
  return nt <= 2 ? (mt == 2 ? 768 : 1024) : 256 * (3 - mt);
}

// Shared memory, in floats: the weight of a group of kg taps as it lies in
// W, [kg][CH][NC + 2] (rows padded so that the B-fragment loads meet no
// bank conflict), then the halo [HH][WW][CH]
__host__ __device__ inline int w_floats(int kg, int nt) {
  return kg * CH * (8 * nt + 2);
}

// x[b, y, xx, c .. c+3], zero outside the image and past C
__device__ __forceinline__ float4 corner(const float* __restrict__ x,
                                         const Geom& g, int b, int y, int xx,
                                         int c) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (y < 0 || y >= g.H || xx < 0 || xx >= g.W || c >= g.C) return v;
  const float* p = x + (((long long)b * g.H + y) * g.W + xx) * g.C + c;
  if (g.C % 4 == 0) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (c + 1 < g.C) v.y = __ldg(p + 1);
  if (c + 2 < g.C) v.z = __ldg(p + 2);
  if (c + 3 < g.C) v.w = __ldg(p + 3);
  return v;
}

// the bilinear sample of the corners a = (y0, x0), b = (y0, x0+1),
// c = (y0+1, x0), d = (y0+1, x0+1) with their weights (the mask folded in)
__device__ __forceinline__ float bilerp(float w00, float w01, float w10,
                                        float w11, float a, float b, float c,
                                        float d) {
  return fmaf(w11, d, fmaf(w10, c, fmaf(w01, b, w00 * a)));
}

// MT m16n8 tiles of pixels a warp (32 or 16 pixels); a block has ts warps
// for each 16 MT pixels, each taking a slice of the taps
template <int NT, bool HALO, int MT>
__global__ void __launch_bounds__(max_threads(NT, MT))
    deform_fused_kernel(const float* __restrict__ x,
                        const float* __restrict__ off,
                        const float* __restrict__ mask,
                        const float* __restrict__ w, float* __restrict__ out,
                        Geom g) {
  constexpr int NC = 8 * NT;   // output channels of a block
  constexpr int S = NC + 2;    // padded weight row
  extern __shared__ __align__(16) float smem[];
  const int K = g.k * g.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* wr = smem;                                  // [kg][CH][S]
  float* halo = smem + w_floats(g.kg, NT);           // [HH][WW][CH]

  const int gq = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * g.rows;
  const int nco = (g.Co + NC - 1) / NC;
  const int b = blockIdx.z / nco, n0 = (blockIdx.z % nco) * NC;
  // the warp's 16 MT pixels: row r of the tile, columns q0 .. q0 + 16 MT - 1;
  // its taps: slice `slice` of ts, [tap0, tap1)
  const int npw = g.rows * (2 / MT), pw = warp % npw, slice = warp / npw;
  const int r = pw / (2 / MT), q0 = 16 * MT * (pw % (2 / MT));
  const int tap0 = K * slice / g.ts, tap1 = K * (slice + 1) / g.ts;
  const int i = i0 + r;
  const int hy0 = i0 - g.pad - g.R, hx0 = j0 - g.pad - g.R;  // halo origin
  const float R = (float)g.R;

  // the pixel whose sampling entry this lane computes, column qp (where
  // MT = 1, lanes t and t + 2 of a group the same); its offsets and mask are
  // fetched a tap ahead of their use
  const int qp = q0 + gq + 8 * (tq % (2 * MT));
  const bool valid = i < g.Ho && j0 + qp < g.Wo;
  const long long pix = valid ? ((long long)b * g.Ho + i) * g.Wo + j0 + qp : 0;
  const float2* offp = reinterpret_cast<const float2*>(off) + pix * K;
  const float* mp = mask ? mask + pix * K : nullptr;
  float2 d = make_float2(0.f, 0.f);
  float m = 0.f;
  auto fetch = [&](int kk) {
    if (valid) {
      d = __ldg(offp + kk);
      m = mp ? __ldg(mp + kk) : 1.f;
    }
  };
  // tap kk's entry for pixel qp: the row weights m (1 - ty), m ty, the
  // column fraction tx, and the top-left corner as an index into the halo
  // (a halo of HH x WW, staged or not)
  float4 ent;
  auto put = [&](int kk) {
    const int ky = kk / g.k, kx = kk - ky * g.k;
    const float dy = fminf(fmaxf(d.x, -R), R), dx = fminf(fmaxf(d.y, -R), R);
    const float fy = floorf(dy), fx = floorf(dx);
    const float ty = dy - fy, tx = dx - fx;
    const int y0 = r + g.dil * ky + (int)fy + g.R;
    const int x0 = qp + g.dil * kx + (int)fx + g.R;
    ent = make_float4(m * (1.f - ty), m * ty, tx,
                      __int_as_float(y0 * g.WW + x0));
  };

  float total[MT][NT][4] = {};
  float part[MT][NT][4] = {};

  for (int c0 = 0; c0 < g.C; c0 += CH) {
    if (c0) __syncthreads();   // the last chunk's reads of halo and weight
    if (HALO) {
      const int nvec = g.WW * (CH / 4);
      for (int hy = warp; hy < g.HH; hy += nwarps) {
        const int gy = hy0 + hy;
        for (int e = lane; e < nvec; e += 32) {
          const int gx = hx0 + (e >> 2), c = c0 + 4 * (e & 3);
          const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
          const float* src =
              in ? x + (((long long)b * g.H + gy) * g.W + gx) * g.C + c : x;
          float* dst = halo + (hy * g.WW * CH) + 4 * e;
          if (g.C % 4 == 0) {
            tf32x3::cp_async16(dst, src, in && c < g.C ? 16 : 0);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              tf32x3::cp_async4(dst + v, in && c + v < g.C ? src + v : x,
                                in && c + v < g.C ? 4 : 0);
          }
        }
      }
    }
    for (int k0 = 0; k0 < K; k0 += g.kg) {
      const int kn = min(g.kg, K - k0);
      if (k0) __syncthreads();   // the last group's weight reads
      // the group's weight: wr[kk][cc][o] = W[k0 + kk, c0 + cc, n0 + o]
      for (int e = threadIdx.x; e < kn * CH * NC; e += blockDim.x) {
        const int o = e % NC, cc = (e / NC) % CH, kk = e / (NC * CH);
        const bool in = c0 + cc < g.C && n0 + o < g.Co;
        tf32x3::cp_async4(
            wr + (kk * CH + cc) * S + o,
            in ? w + ((long long)(k0 + kk) * g.C + c0 + cc) * g.Co + n0 + o
               : w,
            in ? 4 : 0);
      }
      tf32x3::cp_async_commit();
      // the warp's taps in this group
      const int ka = max(k0, tap0), kb = min(k0 + kn, tap1);
      if (ka < kb) fetch(ka);
      tf32x3::cp_async_wait<0>();
      __syncthreads();

      if (ka < kb) put(ka);
      for (int kk = ka; kk < kb; ++kk) {
        const bool more = kk + 1 < kb;
        if (more) fetch(kk + 1);
        const float4 cur = ent;
        // pixel q0 + gq + 8u (its entry from lane 4 gq + u), channels
        // c0 + 4 tq .. + 3
        auto sample = [&](int u) {
          const float wa = __shfl_sync(0xffffffffu, cur.x, u, 4);
          const float wb = __shfl_sync(0xffffffffu, cur.y, u, 4);
          const float tx = __shfl_sync(0xffffffffu, cur.z, u, 4);
          const int at = __float_as_int(__shfl_sync(0xffffffffu, cur.w, u, 4));
          const float w00 = wa * (1.f - tx), w01 = wa * tx;
          const float w10 = wb * (1.f - tx), w11 = wb * tx;
          float4 a, bb, c, dd;
          if (HALO) {
            const float* h = halo + at * CH + 4 * tq;
            a = *reinterpret_cast<const float4*>(h);
            bb = *reinterpret_cast<const float4*>(h + CH);
            c = *reinterpret_cast<const float4*>(h + g.WW * CH);
            dd = *reinterpret_cast<const float4*>(h + g.WW * CH + CH);
          } else {
            const int y = hy0 + at / g.WW, xx = hx0 + at % g.WW;
            const int ch = c0 + 4 * tq;
            a = corner(x, g, b, y, xx, ch);
            bb = corner(x, g, b, y, xx + 1, ch);
            c = corner(x, g, b, y + 1, xx, ch);
            dd = corner(x, g, b, y + 1, xx + 1, ch);
          }
          return make_float4(bilerp(w00, w01, w10, w11, a.x, bb.x, c.x, dd.x),
                             bilerp(w00, w01, w10, w11, a.y, bb.y, c.y, dd.y),
                             bilerp(w00, w01, w10, w11, a.z, bb.z, c.z, dd.z),
                             bilerp(w00, w01, w10, w11, a.w, bb.w, c.w, dd.w));
        };
        // m16n8k8 A fragments: M tile mt, rows g, g + 8 <-> pixels
        // q0 + 16 mt + g, + 8 (u = 2 mt, 2 mt + 1); k-step s: column t <->
        // channel 4t + 2s, column t + 4 <-> 4t + 2s + 1
        tf32x3::FragA fa[2][MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 lo = sample(2 * mt), hi = sample(2 * mt + 1);
          const float s0[4] = {lo.x, hi.x, lo.y, hi.y};
          const float s1[4] = {lo.z, hi.z, lo.w, hi.w};
          fa[0][mt].set(s0);
          fa[1][mt].set(s1);
        }
        // B fragments of tap kk: rows t, t + 4 <-> channels 4t + 2s, + 1
        tf32x3::FragB fb[2][NT];
        const float* wk = wr + ((kk - k0) * CH + 4 * tq) * S + gq;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            fb[s][n].set(wk[2 * s * S + 8 * n], wk[(2 * s + 1) * S + 8 * n]);
        tf32x3::mma_tf32x3<MT, NT>(part, fa[0], fb[0]);
        tf32x3::mma_tf32x3<MT, NT>(part, fa[1], fb[1]);
        tf32x3::fold<MT, NT>(total, part);
        if (more) put(kk + 1);
      }
    }
  }

  if (g.ts > 1) {
    // slices 1 .. ts-1 hand their sums to slice 0, which adds them in order
    float* red = smem;   // [ts - 1][npw][MT NT 4][32]
    __syncthreads();     // the last reads of halo and weight
    constexpr int NV = MT * NT * 4;
    float* mine = red + ((slice - 1) * npw + pw) * NV * 32 + lane;
    if (slice > 0) {
#pragma unroll
      for (int v = 0; v < NV; ++v) mine[v * 32] = (&total[0][0][0])[v];
    }
    __syncthreads();
    if (slice > 0) return;
    for (int t = 1; t < g.ts; ++t) {
      const float* theirs = red + ((t - 1) * npw + pw) * NV * 32 + lane;
#pragma unroll
      for (int v = 0; v < NV; ++v) (&total[0][0][0])[v] += theirs[v * 32];
    }
  }
  if (i >= g.Ho) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + q0 + 16 * mt + 8 * h + gq;
      if (j >= g.Wo) continue;
      float* o = out + (((long long)b * g.Ho + i) * g.Wo + j) * g.Co;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n0 + 8 * n + 2 * tq;
        const float e0 = total[mt][n][2 * h], e1 = total[mt][n][2 * h + 1];
        if (g.Co % 2 == 0) {
          if (c < g.Co) *reinterpret_cast<float2*>(o + c) = make_float2(e0, e1);
        } else {
          if (c < g.Co) o[c] = e0;
          if (c + 1 < g.Co) o[c + 1] = e1;
        }
      }
    }
}

// How one call is tiled (ten ints, in this order): rows, the output
// rows of a tile (1 to 8); mt, the m16n8 tiles of pixels a warp (2: a warp
// a tile row; 1: two); ts, the slices of the taps, a warp each, whose sums
// are added in slice order; halo, 1 where the block stages its input halo
// in shared memory (0: it reads the corners from device memory); nt, the
// m16n8 tiles of output channels a block (chunks of 8 nt channels); kg, the
// taps whose weight a block stages at a time; the dynamic shared memory in
// bytes; the grid.
struct Plan {
  int rows, mt, ts, halo, nt, kg, smem, gx, gy, gz;
};
static_assert(sizeof(Plan) == 10 * sizeof(int), "Plan is the C entry's int[10]");

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// the shared memory, in bytes, of a tiling: the weight group and the halo,
// or after them the slices' sums
inline long long smem_bytes(const Geom& g, int nt, int kg, int rows,
                            bool halo, int mt, int ts) {
  const long long reach = (long long)g.dil * (g.k - 1) + 2LL * g.R + 1;
  const long long tiles =
      w_floats(kg, nt) + (halo ? (rows + reach) * (TW + reach) * CH : 0);
  const long long sums = (long long)(ts - 1) * rows * (2 / mt) * 32 * mt *
                         nt * 4;
  return 4 * (tiles > sums ? tiles : sums);
}

// the warps the busiest of `sms` SMs runs when the blocks spread evenly
inline long long warps_per_sm(const Geom& g, int nco, int rows, int mt,
                              int sms) {
  const long long blocks =
      cdiv(g.Wo, TW) * cdiv(g.Ho, rows) * (long long)g.B * nco;
  return cdiv(blocks, sms) * rows * (2 / mt);
}

// the blocks of deform_fused_kernel<NT, HALO, MT> an SM holds at once with
// `threads` threads and `smem` bytes of shared memory each, by its
// registers, shared memory and threads as the card counts them; 0 where
// the block cannot run
template <int NT, bool HALO, int MT>
int resident_blocks(int threads, int smem) {
  const auto kernel = deform_fused_kernel<NT, HALO, MT>;
  int n = 0;
  if (threads > max_threads(NT, MT) || smem > SMEM_MAX ||
      tf32x3::allow_smem((const void*)kernel, SMEM_MAX) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

template <bool HALO, int MT>
int resident_nt(int nt, int threads, int smem) {
  switch (nt) {
    case 1: return resident_blocks<1, HALO, MT>(threads, smem);
    case 2: return resident_blocks<2, HALO, MT>(threads, smem);
    case 3: return resident_blocks<3, HALO, MT>(threads, smem);
    case 4: return resident_blocks<4, HALO, MT>(threads, smem);
  }
  return 0;
}

// the blocks an SM holds at once for a tiling of one tap slice
inline int resident(int nt, bool halo, int mt, int threads, int smem) {
  if (mt == 2)
    return halo ? resident_nt<true, 2>(nt, threads, smem)
                : resident_nt<false, 2>(nt, threads, smem);
  return halo ? resident_nt<true, 1>(nt, threads, smem)
              : resident_nt<false, 1>(nt, threads, smem);
}

// The tiling of a call on a card with `sms` SMs: as many output channels a
// block as CO_BLOCK allows, spread evenly; the weight of as many taps as
// W_BUDGET holds; the rows a tile (1 to 8), among those whose halo fits in
// shared memory, that take the fewest waves on the busiest SM (its blocks
// over the blocks it holds at once, by registers, shared memory and
// threads: at C = 256 a block of one row takes 39.5 KB for one warp, and an
// SM holds 5 warps of those), then the fewest warps on it, then the most
// rows; 32 pixels a warp, or 16 where that leaves fewer than
// MIN_WARPS_PER_SM warps on the busiest SM; the taps split over as many
// warps (up to MAX_SLICES) as keep the busiest SM within SLICE_WARPS warps
// and the block within max_threads; no halo where even one row's would not
// fit. `force`, where not null, gives rows, mt, ts and halo instead.
Plan choose(const Geom& g, int sms, const int* force) {
  const int K = g.k * g.k;
  const int nco = (int)cdiv(g.Co, CO_BLOCK);
  Plan p{};
  p.nt = (int)cdiv(g.Co, 8 * nco);
  p.kg = W_BUDGET / (4 * CH * (8 * p.nt + 2));
  if (p.kg > K) p.kg = K;
  if (force) {
    p.rows = force[0], p.mt = force[1], p.ts = force[2], p.halo = force[3];
  } else {
    auto fits = [&](int rows) {
      return smem_bytes(g, p.nt, p.kg, rows, true, 2, 1) <= SMEM_MAX;
    };
    const long long blocks_per_row =
        cdiv(g.Wo, TW) * (long long)g.B * nco;   // blocks a tile row
    for (int mt = 2; mt >= 1; --mt) {
      // the busiest SM's blocks over those it holds at once, as bps / held
      long long best = -1, bps_best = 0, held_best = 1;
      for (int rows = 1; rows <= 8; ++rows) {
        const bool halo = fits(rows);
        if (!halo && rows > 1) continue;
        const long long bps = cdiv(blocks_per_row * cdiv(g.Ho, rows), sms);
        const int held = resident(
            p.nt, halo, mt, rows * (2 / mt) * 32,
            (int)smem_bytes(g, p.nt, p.kg, rows, halo, mt, 1));
        if (held <= 0) continue;
        const long long h = held < bps ? held : bps;
        const long long w = warps_per_sm(g, nco, rows, mt, sms);
        if (best < 0 || bps * held_best < bps_best * h ||
            (bps * held_best == bps_best * h && w <= best))
          best = w, bps_best = bps, held_best = h, p.rows = rows;
      }
      p.mt = mt;
      if (best >= MIN_WARPS_PER_SM) break;
    }
    const int max_warps = max_threads(p.nt, p.mt) / 32;
    const long long w = warps_per_sm(g, nco, p.rows, p.mt, sms);
    p.ts = 1;
    while (p.ts < MAX_SLICES && p.ts < K &&
           (p.ts + 1) * p.rows * (2 / p.mt) <= max_warps &&
           (p.ts + 1) * w <= SLICE_WARPS)
      ++p.ts;
    p.halo = fits(p.rows);
  }
  const long long smem = p.mt == 1 || p.mt == 2
      ? smem_bytes(g, p.nt, p.kg, p.rows, p.halo, p.mt, p.ts) : 0;
  p.smem = (int)(smem < (1LL << 30) ? smem : (1LL << 30));
  p.gx = (int)cdiv(g.Wo, TW);
  p.gy = p.rows > 0 ? (int)cdiv(g.Ho, p.rows) : 0;
  p.gz = g.B * nco;
  return p;
}

template <int NT, bool HALO, int MT>
int launch(const float* x, const float* off, const float* mask,
           const float* w, float* out, const Geom& g, const Plan& p,
           cudaStream_t s) {
  const int threads = g.rows * (2 / MT) * g.ts * 32;
  if (p.smem > SMEM_MAX || threads > max_threads(NT, MT))
    return (int)cudaErrorInvalidValue;
  const auto kernel = deform_fused_kernel<NT, HALO, MT>;
  const int err = tf32x3::allow_smem((const void*)kernel, SMEM_MAX);
  if (err) return err;
  kernel<<<dim3(p.gx, p.gy, p.gz), threads, p.smem, s>>>(x, off, mask, w,
                                                          out, g);
  return (int)cudaGetLastError();
}

template <bool HALO, int MT>
int launch_nt(const float* x, const float* off, const float* mask,
              const float* w, float* out, const Geom& g, const Plan& p,
              cudaStream_t s) {
  switch (p.nt) {
    case 1: return launch<1, HALO, MT>(x, off, mask, w, out, g, p, s);
    case 2: return launch<2, HALO, MT>(x, off, mask, w, out, g, p, s);
    case 3: return launch<3, HALO, MT>(x, off, mask, w, out, g, p, s);
    case 4: return launch<4, HALO, MT>(x, off, mask, w, out, g, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the SMs of the current device, read once a device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

}  // namespace

// x: float32 [B, H, W, C]; off: float32 [B, Ho, Wo, k*k, 2] as (dy, dx);
// mask: float32 [B, Ho, Wo, k*k] or null (no modulation); w: float32
// [k*k, C, Co] (tap-major, = [k*k*C, Co]); out: float32 [B, Ho, Wo, Co],
// Ho = H + 2 pad - dil (k-1), Wo likewise; all contiguous and 16-byte
// aligned. window: the clamp R of the offsets. plan: null, or an int[10]
// (struct Plan) into which the tiling the call ran is written; where its
// first int is above 0 on entry, its first four (rows, mt, ts, halo) are
// taken as the tiling instead of the one `choose` picks. stream: a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int deform_sample_forward(const float* x, const float* off,
                                     const float* mask, const float* w,
                                     float* out, int B, int H, int W, int C,
                                     int Co, int k, int pad, int dil,
                                     int window, int* plan, void* stream) {
  Geom g{B, H, W, C, Co, k, pad, dil, window, 0, 0, 0, 0, 0, 0, 0};
  g.Ho = H + 2 * pad - dil * (k - 1);
  g.Wo = W + 2 * pad - dil * (k - 1);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || k <= 0 ||
      dil <= 0 || pad < 0 || window < 0 || g.Ho <= 0 || g.Wo <= 0)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = choose(g, sms, plan && plan[0] > 0 ? plan : nullptr);
  if (plan) *reinterpret_cast<Plan*>(plan) = p;
  if (p.rows < 1 || p.rows > 8 || (p.mt != 1 && p.mt != 2) || p.ts < 1 ||
      p.ts > k * k || (p.halo != 0 && p.halo != 1))
    return (int)cudaErrorInvalidValue;
  g.rows = p.rows, g.kg = p.kg, g.ts = p.ts;
  g.HH = p.rows + dil * (k - 1) + 2 * window + 1;
  g.WW = TW + dil * (k - 1) + 2 * window + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.mt == 2)
    return p.halo ? launch_nt<true, 2>(x, off, mask, w, out, g, p, s)
                  : launch_nt<false, 2>(x, off, mask, w, out, g, p, s);
  return p.halo ? launch_nt<true, 1>(x, off, mask, w, out, g, p, s)
                : launch_nt<false, 1>(x, off, mask, w, out, g, p, s);
}
