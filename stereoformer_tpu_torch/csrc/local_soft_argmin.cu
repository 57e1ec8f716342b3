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
// Design: a group of G lanes per pixel and 32 pixels per block, as
// csrc/local_soft_argmin_bwd.cu, G chosen at launch from the pixel count
// (lanes_for: 2 at LowCNN's eval shapes, 4 at its training shapes). The
// block's volume rows [32, D] and candidate rows [32, S] are contiguous in
// memory and are staged in shared memory with cp.async, every 16-byte piece
// in flight at once, so the block waits about one round trip to memory.
// Lane j of a group then takes the candidates s = j, j + G, .... Of the
// hat's D weights only those at floor(c) and floor(c) + 1 can be nonzero,
// so the kernel evaluates the hat there (with the hat's own formula) and
// skips the rest. The softmax subtracts the group's maximum; maximum, sum
// and weighted sum are combined over the group's lanes by XOR shuffles in a
// fixed order. Nothing is sized by D or S but the shared rows, which the
// launch sizes, so any D and S whose rows fit in shared memory are taken.

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

// floats of shared memory per block: the volume rows [PIX][D], the
// candidate rows [PIX][S] and the re-sampled values [PIX][S | 1] (the odd
// stride keeps one lane per pixel free of bank conflicts there)
__host__ __device__ inline size_t smem_floats(int D, int S) {
  return (size_t)section(PIX * D) + section(PIX * S) + PIX * (S | 1);
}

template <int G>
__global__ void __launch_bounds__(32 * G)
local_soft_argmin_kernel(const float* __restrict__ vol,
                         const float* __restrict__ cand,
                         float* __restrict__ out, int N, int D, int S) {
  constexpr int THREADS = 32 * G;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);
  float* cs = vs + section(PIX * D);
  float* ls = cs + section(PIX * S);

  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, (long long)N - p0);
  // the block's rows, 16-byte aligned, the last piece zero-filled
  for (int i = threadIdx.x; 4 * i < np * D; i += THREADS)
    cp_async16(vs + 4 * i, vol + p0 * D + 4 * i, 4 * min(4, np * D - 4 * i));
  for (int i = threadIdx.x; 4 * i < np * S; i += THREADS)
    cp_async16(cs + 4 * i, cand + p0 * S + 4 * i, 4 * min(4, np * S - 4 * i));
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const float* v = vs + grp * D;
  const float* c = cs + grp * S;
  float* local = ls + grp * (S | 1);
  const float dmax = (float)(D - 1);
  float m = -INFINITY;
  for (int s = lane; s < S; s += G) {
    const float x = fminf(fmaxf(c[s], 0.f), dmax);
    const float f = floorf(x);
    const int i0 = (int)f;
    float val = v[i0] * fmaxf(0.f, 1.f - fabsf(x - f));
    if (i0 + 1 < D) val += v[i0 + 1] * fmaxf(0.f, 1.f - fabsf(x - (f + 1.f)));
    local[s] = val;
    m = fmaxf(m, val);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float sum = 0.f, acc = 0.f;
  for (int s = lane; s < S; s += G) {
    const float e = expf(local[s] - m);
    sum += e;
    acc += e * c[s];
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, o);
    acc += __shfl_xor_sync(FULL, acc, o);
  }
  if (grp < np && lane == 0) out[p0 + grp] = acc / sum;
}

// lanes per pixel: the fewest (up to 4) that still give every one of the
// H100's 132 SMs 32 warps (2 at LowCNN's eval shapes, 4 at its training
// shapes)
int lanes_for(long long N) {
  int g = 1;
  while (g < 4 && N * g < 132LL * 32 * 32) g *= 2;
  return g;
}

template <int G>
int launch(const float* vol, const float* cand, float* out, int N, int D,
           int S, cudaStream_t stream) {
  const size_t smem = smem_floats(D, S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_soft_argmin_kernel<G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((N + (long long)PIX - 1) / PIX);
  local_soft_argmin_kernel<G><<<blocks, 32 * G, smem, stream>>>(
      vol, cand, out, N, D, S);
  return (int)cudaGetLastError();
}

}  // namespace

// vol: float32 [N, D] contiguous; cand: float32 [N, S] contiguous, both
// 16-byte aligned; out: float32 [N] contiguous; stream: a cudaStream_t.
// Returns the error of the shared-memory setting or cudaGetLastError() after
// the launch (0 when it was accepted); rows too long for shared memory are
// refused there.
extern "C" int local_soft_argmin_forward(const float* vol, const float* cand,
                                         float* out, int N, int D, int S,
                                         void* stream) {
  if (N <= 0 || D <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes_for(N)) {
    case 1: return launch<1>(vol, cand, out, N, D, S, st);
    case 2: return launch<2>(vol, cand, out, N, D, S, st);
    case 4: return launch<4>(vol, cand, out, N, D, S, st);
    default: return launch<8>(vol, cand, out, N, D, S, st);
  }
}
