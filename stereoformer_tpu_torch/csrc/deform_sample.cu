// Windowed modulated deformable sampling (DCNv2, stride 1) on Hopper (sm_90a).
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/deform_sample.py::_forward
// (body `_kernel`). As there, the tap contraction comes first and is a plain
// matrix product outside the kernel: G = x . W_k for every tap k, laid out
// channels-last as G[b, y, x, k, o] (the wrapper computes it with one
// torch.matmul of the unpadded x). The kernel then forms, for each output
// pixel p = (b, i, j) and output channel o,
//     out[p, o] = sum_k m_k[p] * bilerp(G_k, i - pad + dil*ky + dy_k,
//                                           j - pad + dil*kx + dx_k)[o]
// with (dy_k, dx_k) = offsets clamped to [-R, R] and samples outside the
// image read as zero (the Pallas kernel's zero-padded xpad). The bilinear
// corner form gives the value of the Pallas kernel's (2R+2)^2 hat sum, since
// at most four of those hats are nonzero, in a ninth of its reads.
//
// What bounds it on the H100: memory. Each output pixel reads K*Co floats of
// G (up to four corners of each tap, mostly from cache: neighbouring pixels
// share their corners), 3K floats of offsets and mask, and writes Co floats;
// it does about 8 FMAs per float of G it reads.
//
// Design: one thread per output pixel and run of 4 output channels, so a
// pixel's Co = 16 channels are 4 neighbouring threads reading one 64-byte
// row of G_k per corner (a float4 each when Co % 4 == 0, scalar loads
// otherwise). A thread clamps its pixel's offsets, splits each into floor
// and fraction (the fraction taken from the offset itself, not from the
// absolute coordinate, so that no bits are lost to the pixel index), folds
// the mask into the row weights and accumulates the four corners of the K
// taps in registers. The backward is autograd of the plain windowed form, as
// the Pallas kernel's VJP is.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC4>
__global__ void deform_sample_kernel(const float* __restrict__ G,
                                     const float* __restrict__ off,
                                     const float* __restrict__ mask,
                                     float* __restrict__ out, int B, int H,
                                     int W, int Ho, int Wo, int k, int Co,
                                     int pad, int dil, float R) {
  const int nchunk = (Co + 3) / 4;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * Ho * Wo * nchunk) return;
  const int c0 = 4 * (int)(t % nchunk);
  const long long p = t / nchunk;  // output pixel, (b, i, j) row-major
  const int j = (int)(p % Wo);
  const int i = (int)((p / Wo) % Ho);
  const int b = (int)(p / ((long long)Ho * Wo));
  const int K = k * k;
  const long long KCo = (long long)K * Co;
  const float* gb = G + (long long)b * H * W * KCo + c0;
  const float* op = off + p * 2 * K;
  const float* mp = mask ? mask + p * K : nullptr;
  const int nc = min(4, Co - c0);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kk = 0; kk < K; ++kk) {
    const float dy = fminf(fmaxf(op[2 * kk], -R), R);
    const float dx = fminf(fmaxf(op[2 * kk + 1], -R), R);
    const float m = mp ? mp[kk] : 1.f;
    const float fy = floorf(dy), fx = floorf(dx);
    const float ty = dy - fy, tx = dx - fx;
    const int y0 = i - pad + dil * (kk / k) + (int)fy;
    const int x0 = j - pad + dil * (kk % k) + (int)fx;
    const float wy[2] = {m * (1.f - ty), m * ty};
    const float wx[2] = {1.f - tx, tx};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int y = y0 + a;
      if (y < 0 || y >= H) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = x0 + e;
        if (x < 0 || x >= W) continue;
        const float w = wy[a] * wx[e];
        const float* g = gb + ((long long)y * W + x) * KCo + (long long)kk * Co;
        if (VEC4) {
          const float4 v = *reinterpret_cast<const float4*>(g);
          acc[0] = fmaf(w, v.x, acc[0]);
          acc[1] = fmaf(w, v.y, acc[1]);
          acc[2] = fmaf(w, v.z, acc[2]);
          acc[3] = fmaf(w, v.w, acc[3]);
        } else {
          for (int n = 0; n < nc; ++n) acc[n] = fmaf(w, g[n], acc[n]);
        }
      }
    }
  }
  float* o = out + p * Co + c0;
  if (VEC4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int n = 0; n < nc; ++n) o[n] = acc[n];
  }
}

}  // namespace

// G: float32 [B, H, W, k*k, Co]; off: float32 [B, Ho, Wo, k*k, 2] as (dy, dx);
// mask: float32 [B, Ho, Wo, k*k] or null (no modulation); out: float32
// [B, Ho, Wo, Co]; all contiguous and 16-byte aligned. window: the clamp R
// of the offsets. stream: a cudaStream_t. Returns cudaGetLastError() after
// the launch (0 when it was accepted).
extern "C" int deform_sample_forward(const float* G, const float* off,
                                     const float* mask, float* out, int B,
                                     int H, int W, int Ho, int Wo, int k,
                                     int Co, int pad, int dil, int window,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || k <= 0 || Co <= 0 ||
      dil <= 0 || pad < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Ho * Wo * ((Co + 3) / 4);
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (Co % 4 == 0)
    deform_sample_kernel<true><<<blocks, THREADS, 0, s>>>(
        G, off, mask, out, B, H, W, Ho, Wo, k, Co, pad, dil, (float)window);
  else
    deform_sample_kernel<false><<<blocks, THREADS, 0, s>>>(
        G, off, mask, out, B, H, W, Ho, Wo, k, Co, pad, dil, (float)window);
  return (int)cudaGetLastError();
}
