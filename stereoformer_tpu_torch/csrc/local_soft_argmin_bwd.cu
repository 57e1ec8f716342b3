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
// against a few dozen flops and S exponentials. At the training shapes
// (12,800 pixels, 4.7 MB) the bound is ~1.4 us, below the cost of a launch.
//
// Design, as the forward: one thread per pixel, PIX pixels per block. The
// block's volume rows [PIX, D] and candidate rows [PIX, S] are contiguous in
// memory and are staged in shared memory with cp.async, every 16-byte piece in
// flight at once. Each thread recomputes its pixel's S re-sampled values from
// the two hat taps at floor(c) and floor(c) + 1 only, keeps them in registers
// for a max-subtracted softmax, then walks the S candidates once: it writes
// dcand over its own candidate row in shared memory and adds the two taps of
// dvol into its own row of a zeroed shared buffer. No thread touches another
// thread's rows, so there are no atomics and the result is deterministic. The
// block then stores both shared buffers with coalesced 16-byte stores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PIX = 64;      // pixels (threads) per block
constexpr int D_MAX = 48;    // most disparity bins (shared memory < 48 KB)
constexpr int S_MAX = 32;    // most candidates a pixel may have

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// copy n floats from 16-byte aligned src to dst, the last piece zero-filled
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; 4 * i < n; i += PIX)
    cp_async16(dst + 4 * i, src + 4 * i, 4 * min(4, n - 4 * i));
}

// store n floats from shared src to 16-byte aligned global dst
__device__ __forceinline__ void unstage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; 4 * i < n; i += PIX) {
    if (4 * i + 4 <= n) {
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    } else {
      for (int j = 4 * i; j < n; ++j) dst[j] = src[j];
    }
  }
}

__global__ void local_soft_argmin_bwd_kernel(
    const float* __restrict__ vol, const float* __restrict__ cand,
    const float* __restrict__ g, float* __restrict__ dvol,
    float* __restrict__ dcand, int N, int D, int S) {
  extern __shared__ float4 smem4[];
  const int rows_d = (PIX * D + 3) & ~3;        // 16-byte aligned sections
  float* vs = reinterpret_cast<float*>(smem4);  // [PIX][D] volume
  float* dvs = vs + rows_d;                     // [PIX][D] dvol
  float* cs = dvs + rows_d;                     // [PIX][S] cand, then dcand

  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, (long long)N - p0);
  stage(vs, vol + p0 * D, np * D);
  stage(cs, cand + p0 * S, np * S);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < np * D; i += PIX) dvs[i] = 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < np) {
    const float* v = vs + t * D;
    float* dv = dvs + t * D;
    float* c = cs + t * S;
    const float dmax = (float)(D - 1);
    const float gp = g[p0 + t];

    float e[S_MAX];   // re-sampled values, then their exponentials
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < S_MAX; ++s) {
      if (s < S) {
        const float x = fminf(fmaxf(c[s], 0.f), dmax);
        const float f = floorf(x);
        const int i0 = (int)f;
        float val = v[i0] * fmaxf(0.f, 1.f - fabsf(x - f));
        if (i0 + 1 < D)
          val += v[i0 + 1] * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
        e[s] = val;
        m = fmaxf(m, val);
      }
    }
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < S_MAX; ++s) {
      if (s < S) {
        e[s] = expf(e[s] - m);
        sum += e[s];
        acc += e[s] * c[s];
      }
    }
    const float inv = 1.f / sum;
    const float out = acc * inv;

#pragma unroll
    for (int s = 0; s < S_MAX; ++s) {
      if (s < S) {
        const float cand_s = c[s];
        const float x = fminf(fmaxf(cand_s, 0.f), dmax);
        const float f = floorf(x);
        const int i0 = (int)f;
        const float gs = gp * (e[s] * inv);           // g * score_s
        const float dl = gs * (cand_s - out);         // dlocal_s
        dv[i0] += dl * fmaxf(0.f, 1.f - fabsf(x - f));
        float hat = 0.f;                              // d local_s / d c_s
        if (i0 + 1 < D) {
          dv[i0 + 1] += dl * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
          if (x > f) hat = v[i0 + 1] - v[i0];
        }
        const float cg = (cand_s > 0.f ? 1.f : (cand_s < 0.f ? 0.f : 0.5f)) *
                         (cand_s < dmax ? 1.f : (cand_s > dmax ? 0.f : 0.5f));
        c[s] = gs + dl * hat * cg;
      }
    }
  }
  __syncthreads();
  unstage(dvol + p0 * D, dvs, np * D);
  unstage(dcand + p0 * S, cs, np * S);
}

}  // namespace

// vol: float32 [N, D]; cand: float32 [N, S]; g: float32 [N]; dvol: float32
// [N, D]; dcand: float32 [N, S]; all contiguous and 16-byte aligned; stream:
// a cudaStream_t. Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int local_soft_argmin_backward(const float* vol, const float* cand,
                                          const float* g, float* dvol,
                                          float* dcand, int N, int D, int S,
                                          void* stream) {
  if (N <= 0 || D <= 0 || S <= 0 || S > S_MAX || D > D_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * ((PIX * D + 3) & ~3) + PIX * S) * sizeof(float);
  const int blocks = (int)((N + (long long)PIX - 1) / PIX);
  local_soft_argmin_bwd_kernel<<<blocks, PIX, smem, (cudaStream_t)stream>>>(
      vol, cand, g, dvol, dcand, N, D, S);
  return (int)cudaGetLastError();
}
