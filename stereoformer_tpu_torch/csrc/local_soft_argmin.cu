// Local soft-argmin over re-sampled disparity candidates on Hopper (sm_90a).
//
// Replaces the TPU kernel stereoformer_tpu/ops/pallas/local_refine.py::_forward
// (body `_kernel`). For each pixel p, with a volume row vol[p, 0..D-1] and
// candidates cand[p, 0..S-1], and c_s = clip(cand[p,s], 0, D-1):
//     local[s] = sum_d vol[p,d] * max(0, 1 - |c_s - d|)    (hat re-sample)
//     out[p]   = sum_s softmax(local)[s] * cand[p,s]        (unclipped cands)
//
// What bounds it on the H100: memory. Each pixel reads D + S floats and
// writes one, (24 + 21 + 1) * 4 bytes at the main path's shapes, against a
// few dozen flops and S exponentials: far below the card's compute rates.
//
// Design: one thread per pixel, PIX pixels per block. The block's volume
// rows [PIX, D] and candidate rows [PIX, S] are contiguous in memory. They
// are copied to shared memory with cp.async in 16-byte pieces, every piece
// of the block in flight at once and no registers spent on them; every block
// is resident at once, so the kernel takes about one round trip to memory
// plus its arithmetic. Each thread then reads its own rows from shared
// memory. Of the hat's D weights only those at floor(c) and floor(c) + 1 can
// be nonzero, so the kernel evaluates the hat there (with the hat's own
// formula) and skips the rest. The softmax subtracts the maximum over S;
// the S re-sampled values stay in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PIX = 128;     // pixels (threads) per block
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

__global__ void local_soft_argmin_kernel(const float* __restrict__ vol,
                                         const float* __restrict__ cand,
                                         float* __restrict__ out, int N,
                                         int D, int S) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // [PIX][D]
  float* cs = vs + ((PIX * D + 3) & ~3);        // [PIX][S], 16-byte aligned

  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, (long long)N - p0);
  stage(vs, vol + p0 * D, np * D);
  stage(cs, cand + p0 * S, np * S);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= np) return;
  const float* v = vs + t * D;
  const float* c = cs + t * S;
  const float dmax = (float)(D - 1);

  float local[S_MAX];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < S_MAX; ++s) {
    if (s < S) {
      const float x = fminf(fmaxf(c[s], 0.f), dmax);
      const float f = floorf(x);
      const int i0 = (int)f;
      float val = v[i0] * fmaxf(0.f, 1.f - fabsf(x - f));
      if (i0 + 1 < D) val += v[i0 + 1] * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
      local[s] = val;
      m = fmaxf(m, val);
    }
  }
  float sum = 0.f, acc = 0.f;
#pragma unroll
  for (int s = 0; s < S_MAX; ++s) {
    if (s < S) {
      const float e = expf(local[s] - m);
      sum += e;
      acc += e * c[s];
    }
  }
  out[p0 + t] = acc / sum;
}

}  // namespace

// vol: float32 [N, D] contiguous; cand: float32 [N, S] contiguous, both
// 16-byte aligned; out: float32 [N] contiguous; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int local_soft_argmin_forward(const float* vol, const float* cand,
                                         float* out, int N, int D, int S,
                                         void* stream) {
  if (N <= 0 || D <= 0 || S <= 0 || S > S_MAX || D > D_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(((PIX * D + 3) & ~3) + PIX * S) * sizeof(float);
  const int blocks = (int)((N + (long long)PIX - 1) / PIX);
  local_soft_argmin_kernel<<<blocks, PIX, smem, (cudaStream_t)stream>>>(
      vol, cand, out, N, D, S);
  return (int)cudaGetLastError();
}
