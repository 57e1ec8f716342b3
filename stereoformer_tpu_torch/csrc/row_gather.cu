// Row gather on Hopper (sm_90a): out[i, c] = img[idx[i, c], c].
//
// Replaces the TPU kernel of scripts/_gather_probe.py::main (its body
// `kernel`: jnp.take_along_axis(img, idx, axis=0) on a VMEM block), a probe
// of whether Mosaic lowers an arbitrary-range sublane gather. On a GPU a
// gather is a plain indexed load.
//
// What bounds it on the H100: memory. Each output element reads one index
// and one value and writes one value, no arithmetic but the address.
//
// Design: one thread per output element, in row-major order, so a warp
// reads 32 consecutive indices, writes 32 consecutive outputs, and reads
// the gathered values row by row (consecutive channels of one image row
// where the index is constant along a row, as in the probe). An index
// outside [0, N) reads nothing and yields NaN; the wrapper refuses such
// indices before the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__global__ void row_gather_kernel(const float* __restrict__ img,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long n,
                                  int N, int C) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int r = idx[t];
  out[t] = (r >= 0 && r < N) ? img[(long long)r * C + t % C] : nanf("");
}

}  // namespace

// img float32 [N, C], idx int32 [M, C], out float32 [M, C], all contiguous.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int row_gather_forward(const float* img, const int* idx,
                                  float* out, int N, int M, int C,
                                  void* stream) {
  if (N <= 0 || M < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)M * C;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      img, idx, out, n, N, C);
  return (int)cudaGetLastError();
}
