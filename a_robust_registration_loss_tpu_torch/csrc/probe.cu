// Probe of the card's achievable fp32 rate outside the tensor cores: a
// logistic map with no memory traffic in its loop.
//
// Replaces the TPU kernel bench.py:measured_vpu_peak (its kern, launched by
// pl.pallas_call), which measured the TPU's vector-unit rate the same way.
// Each thread holds kChains = 4 independent fp32 values, x * (0.1 + 0.2 c)
// for chain c from its input element x, and iterates x <- (r * x) * (1 - x)
// iters * kUnroll times: 3 operations per element-iteration, a multiply, a
// subtract and a multiply, none of them a fused multiply-add (-fmad=false).
// r = x[0] * 3.9 is loaded at run time, so nothing folds; the chains' sum is
// written out, so nothing is dead.
//
// Bound on the H100: operations by design; 8 bytes per element against
// 3 * iters * kUnroll * kChains operations. The time it measures is the
// denominator of every kernel's operation bound in chip_smoke.py: the kernels
// of this library are built without FMA, so the data sheet's 67 TFLOP/s,
// which counts an FMA as two operations, is out of their reach.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;
constexpr int kChains = 4;  // bench.py:measured_vpu_peak's default

__global__ void __launch_bounds__(kThreads)
logistic_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float r = x[0] * 3.9f;
  const float x0 = x[i];
  float xs[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) xs[c] = x0 * static_cast<float>(0.1 + 0.2 * c);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) xs[c] = (r * xs[c]) * (1.f - xs[c]);
    }
  }
  float acc = xs[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = acc + xs[c];
  out[i] = acc;
}

}  // namespace

// x, out (n,) contiguous fp32 on the device; the map runs iters * 16 times.
// Returns cudaGetLastError() after the launch.
extern "C" int arrl_logistic(const float* x, float* out, int n, int iters,
                             void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  logistic_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}
