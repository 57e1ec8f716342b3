// Backward of the local soft-argmin on Hopper (sm_90a).
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/local_refine.py::_backward
// (body `_bwd_kernel`), the fused VJP of csrc/local_soft_argmin.cu. For each
// pixel p, with a volume row vol[p, 0..D-1], candidates cand[p, 0..S-1], the
// output's cotangent g[p], c_s = clip(cand[p,s], 0, D-1), f_s = floor(c_s) and
// the hat weights w_sd = max(0, 1 - |c_s - d|):
//     local[s] = sum_d w_sd * vol[p,d],  score = softmax(local),
//     out      = sum_s score[s] * cand[p,s]
//     dlocal_s = g * score[s] * (cand[p,s] - out)
//     dvol[p,d]  = sum_s dlocal_s * w_sd                (all D entries written)
//     dcand[p,s] = g * score[s]
//                + dlocal_s * (vol[f_s+1] - vol[f_s]) * cg_s   (0 if c_s == f_s)
// where cg_s, the derivative of the clip, is 1 strictly inside (0, D-1), 0
// outside and 0.5 at a bound, as `_bwd_kernel` takes it (the hat term it
// multiplies is 0 at the bounds, so the choice changes no value).
//
// What bounds it on the H100: memory. Each pixel reads D + S + 1 floats and
// writes D + S, (24 + 21 + 1 + 24 + 21) * 4 bytes at the main path's shapes,
// against a few hundred flops and S exponentials. At the training shapes
// (12,800 pixels, 4.7 MB) the bound is ~1.4 us, below the cost of a launch.
//
// Design: a group of G lanes per pixel and 32 pixels per block, G chosen at
// launch from the pixel count (lanes_for): more lanes shorten each pixel's
// chain of dependent steps but add shuffles, so one lane a pixel where the
// image fills the card (LowCNN's eval shapes) and 4 where it does not (its
// training shapes). The block's volume rows [32, D] and candidate rows
// [32, S] are contiguous in memory and are staged in shared memory with
// cp.async, every 16-byte piece in flight at once. Lane j of a group takes
// the candidates s = j, j + G, ...: it re-samples them from the two hat taps
// at floor(c) and floor(c) + 1, keeping each tap's slope for dcand, and the
// group combines maximum, sum and weighted sum of the softmax by XOR
// shuffles in a fixed order. Then lane j writes dcand over its candidates in
// shared memory, and dvol is summed in shared memory where the volume was:
// lane j owns the entries d = j (mod G); the group takes its candidates G at
// a time, and each lane receives each one's tap f_s and its two terms
// dlocal_s * w by shuffles, in s order, and adds those that fall on its
// entries. Every entry is summed by one lane in s order, with no atomics,
// so the result is the same on every call. With one lane a pixel, the
// volume (then dvol) and the per-candidate values are kept pixel-minor
// ([D][32], the staged rows turned into columns and back in shared memory),
// so the 32 lanes' taps at any disparities fall in 32 banks. The block then
// stores both shared buffers with coalesced 16-byte stores. Nothing is
// sized by D or S but the shared rows, which the launch sizes, so any D and
// S whose rows fit in shared memory are taken.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PIX = 32;            // pixels per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// floats of each shared section, rounded up to 16 bytes
__host__ __device__ inline int section(int n) { return (n + 3) & ~3; }

// floats of shared memory per block. With G > 1 lanes a pixel: the volume
// rows [PIX][D] (then dvol), the candidate rows [PIX][S] (then dcand), and
// the re-sampled values (then their exponentials) and the hat's slopes at
// the candidates, each [PIX][S | 1] (odd strides spread a warp's pixels
// over the banks). With one lane: the volume's columns [D][PIX] (then
// dvol's), the candidate rows, and one region that holds the staged volume
// rows and dvol's rows at the start and the end, and the values and slopes
// [S][PIX] between them.
template <int G>
__host__ __device__ inline size_t smem_floats(int D, int S) {
  if (G == 1)
    return (size_t)section(PIX * D) + section(PIX * S) +
           (section(PIX * D) > 2 * PIX * S ? section(PIX * D) : 2 * PIX * S);
  return (size_t)section(PIX * D) + section(PIX * S) + 2 * PIX * (S | 1);
}

// One pixel's backward by its group of G lanes (lane = 0 .. G-1): its volume
// v (replaced by dvol; entry d at v[d * VS]), its candidates c (replaced by
// dcand), its cotangent gp, and S floats each in e and h (entry s at
// e[s * VS]) for the re-sampled values and the hat's slopes; VS is PIX for
// one lane a pixel (its entries lie in columns, one bank a pixel) and 1
// otherwise.
template <int G>
__device__ __forceinline__ void pixel_backward(float* __restrict__ v,
                                               float* __restrict__ c,
                                               float* __restrict__ e,
                                               float* __restrict__ h,
                                               float gp, int lane, int D,
                                               int S) {
  constexpr int VS = G == 1 ? PIX : 1;
  const float dmax = (float)(D - 1);
  float m = -INFINITY;
  for (int s = lane; s < S; s += G) {
    const float x = fminf(fmaxf(c[s], 0.f), dmax);
    const float f = floorf(x);
    const int i0 = (int)f;
    const float v0 = v[i0 * VS];
    float val = v0 * fmaxf(0.f, 1.f - fabsf(x - f));
    float hat = 0.f;                               // d local_s / d c_s
    if (i0 + 1 < D) {
      const float v1 = v[(i0 + 1) * VS];
      val += v1 * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
      if (x > f) hat = v1 - v0;
    }
    e[s * VS] = val;
    h[s * VS] = hat;
    m = fmaxf(m, val);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  __syncwarp();   // the volume is read no more: it becomes dvol
  for (int d = lane; d < D; d += G) v[d * VS] = 0.f;
  float sum = 0.f, acc = 0.f;
  for (int s = lane; s < S; s += G) {
    const float ex = expf(e[s * VS] - m);
    sum += ex;
    acc += ex * c[s];
    e[s * VS] = ex;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, o);
    acc += __shfl_xor_sync(FULL, acc, o);
  }
  const float inv = 1.f / sum;
  const float out = acc * inv;

  for (int k0 = 0; k0 < S; k0 += G) {    // the same steps in every lane
    const int s = k0 + lane;
    int i0 = 0;
    float t0 = 0.f, t1 = 0.f;
    if (s < S) {
      const float cand_s = c[s];
      const float x = fminf(fmaxf(cand_s, 0.f), dmax);
      const float f = floorf(x);
      i0 = (int)f;
      const float gs = gp * (e[s * VS] * inv);     // g * score_s
      const float dl = gs * (cand_s - out);        // dlocal_s
      const float cg = (cand_s > 0.f ? 1.f : (cand_s < 0.f ? 0.f : 0.5f)) *
                       (cand_s < dmax ? 1.f : (cand_s > dmax ? 0.f : 0.5f));
      c[s] = gs + dl * h[s * VS] * cg;
      t0 = dl * fmaxf(0.f, 1.f - fabsf(x - f));
      if (i0 + 1 < D) t1 = dl * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
    }
    // candidates k0, k0 + 1, ... in turn: each lane adds the terms that
    // fall on its entries
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int ij = G == 1 ? i0 : __shfl_sync(FULL, i0, j, G);
      const float a = G == 1 ? t0 : __shfl_sync(FULL, t0, j, G);
      const float b = G == 1 ? t1 : __shfl_sync(FULL, t1, j, G);
      if (k0 + j < S) {
        if (((ij - lane) & (G - 1)) == 0) v[ij * VS] += a;
        if (((ij + 1 - lane) & (G - 1)) == 0 && ij + 1 < D)
          v[(ij + 1) * VS] += b;
      }
    }
  }
}

// One lane a pixel: thread t's row of D floats in `rows` ([PIX][D]) to its
// column in `cols` ([D][PIX]), or back. Thread t starts at d = t % D, so
// the 32 threads read (for even D) and write 32 banks at each step.
__device__ __forceinline__ void turn(float* rows, float* cols, int t, int D,
                                     bool to_cols) {
  int d = t % D;
  for (int j = 0; j < D; ++j) {
    if (to_cols) cols[d * PIX + t] = rows[t * D + d];
    else rows[t * D + d] = cols[d * PIX + t];
    if (++d == D) d = 0;
  }
}

template <int G>
__global__ void __launch_bounds__(32 * G)
local_soft_argmin_bwd_kernel(
    const float* __restrict__ vol, const float* __restrict__ cand,
    const float* __restrict__ g, float* __restrict__ dvol,
    float* __restrict__ dcand, int N, int D, int S) {
  constexpr int THREADS = 32 * G;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  // G > 1: rows, cs, es, hs; one lane: cols, cs, then rows aliasing es, hs
  float* cols = base;
  float* rows = G == 1 ? base + section(PIX * D) + section(PIX * S) : base;
  float* cs = base + section(PIX * D);
  float* es = G == 1 ? rows : cs + section(PIX * S);
  float* hs = es + (G == 1 ? PIX * S : PIX * (S | 1));

  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, (long long)N - p0);
  // the block's rows, 16-byte aligned, the last piece zero-filled
  for (int i = threadIdx.x; 4 * i < np * D; i += THREADS)
    cp_async16(rows + 4 * i, vol + p0 * D + 4 * i,
               4 * min(4, np * D - 4 * i));
  for (int i = threadIdx.x; 4 * i < np * S; i += THREADS)
    cp_async16(cs + 4 * i, cand + p0 * S + 4 * i, 4 * min(4, np * S - 4 * i));
  asm volatile("cp.async.commit_group;\n" ::);
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const float gp = grp < np ? g[p0 + grp] : 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (G == 1) {
    turn(rows, cols, grp, D, true);
    __syncthreads();   // the rows are read: their region holds e and h now
    pixel_backward<1>(cols + grp, cs + grp * S, es + grp, hs + grp, gp, 0,
                      D, S);
    __syncthreads();
    turn(rows, cols, grp, D, false);
  } else {
    pixel_backward<G>(rows + grp * D, cs + grp * S, es + grp * (S | 1),
                      hs + grp * (S | 1), gp, lane, D, S);
  }
  __syncthreads();
  for (int i = threadIdx.x; 4 * i < np * D; i += THREADS) {
    if (4 * i + 4 <= np * D)
      reinterpret_cast<float4*>(dvol + p0 * D)[i] =
          reinterpret_cast<const float4*>(rows)[i];
    else
      for (int j = 4 * i; j < np * D; ++j) dvol[p0 * D + j] = rows[j];
  }
  for (int i = threadIdx.x; 4 * i < np * S; i += THREADS) {
    if (4 * i + 4 <= np * S)
      reinterpret_cast<float4*>(dcand + p0 * S)[i] =
          reinterpret_cast<const float4*>(cs)[i];
    else
      for (int j = 4 * i; j < np * S; ++j) dcand[p0 * S + j] = cs[j];
  }
}

// lanes per pixel: the fewest (up to 4) that still give every one of the
// H100's 132 SMs 16 warps (1 at LowCNN's eval shapes, 4 at its training
// shapes)
int lanes_for(long long N, int D, int S) {
  int g = 1;
  while (g < 4 && N * g < 132LL * 16 * 32) g *= 2;
  // one lane's columns beside the rows must fit the H100's 227 KB
  if (g == 1 && smem_floats<1>(D, S) * sizeof(float) > 227 * 1024) g = 2;
  return g;
}

template <int G>
int launch(const float* vol, const float* cand, const float* g, float* dvol,
           float* dcand, int N, int D, int S, cudaStream_t stream) {
  const size_t smem = smem_floats<G>(D, S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_soft_argmin_bwd_kernel<G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((N + (long long)PIX - 1) / PIX);
  local_soft_argmin_bwd_kernel<G><<<blocks, 32 * G, smem, stream>>>(
      vol, cand, g, dvol, dcand, N, D, S);
  return (int)cudaGetLastError();
}

}  // namespace

// vol: float32 [N, D]; cand: float32 [N, S]; g: float32 [N]; dvol: float32
// [N, D]; dcand: float32 [N, S]; all contiguous and 16-byte aligned; stream:
// a cudaStream_t. Returns the error of the shared-memory setting or
// cudaGetLastError() after the launch (0 when it was accepted); rows too
// long for shared memory are refused there.
extern "C" int local_soft_argmin_backward(const float* vol, const float* cand,
                                          const float* g, float* dvol,
                                          float* dcand, int N, int D, int S,
                                          void* stream) {
  if (N <= 0 || D <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes_for(N, D, S)) {
    case 1: return launch<1>(vol, cand, g, dvol, dcand, N, D, S, st);
    case 2: return launch<2>(vol, cand, g, dvol, dcand, N, D, S, st);
    default: return launch<4>(vol, cand, g, dvol, dcand, N, D, S, st);
  }
}
