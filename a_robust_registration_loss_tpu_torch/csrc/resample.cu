// Candidate stage of the line resampler: uniforms -> two sphere points ->
// direction and origin -> any-hit against two 12-triangle AABB meshes.
//
// Replaces the TPU kernel a_robust_registration_loss_tpu/ops/pallas/
// resample.py:_kernel, launched by sample_and_hit. Op for op the same
// arithmetic, because the barycentric accept A + B + C <= S holds with
// equality in real arithmetic for every interior hit: the label is decided
// by rounding, and any re-association or fused multiply-add moves it. So
// this file is built with -fmad=false, divisions and square roots are the
// IEEE ones (no fast math), and cos/sin are taken in double and rounded once
// to float: the correctly rounded values, which the plain PyTorch version
// reproduces on any device (a float library cos may differ by an ulp between
// two builds, and one ulp in a direction moves the knife-edge labels).
//
// Design: one thread per candidate; the 24 prepped faces (p0 p1 p2 nh S pad,
// 16 floats each) and [r, cx, cy, cz] are read once per block into shared
// memory from device tensors, so the host never syncs to pass them.
// Outputs: cand (C, 6) [direction | origin] and ok (C,) as bytes 0/1.
//
// Bound on the H100: operations, and both bounds are small. Per candidate
// 16 bytes in and 25 out, and 1,990 fp32 operations (24 faces x 81, plus 46
// for the sphere points and the line; each cos/sin counted as one); at
// C = 200,000 that is 398 M operations, 5.9 us at 67 TFLOP/s, against
// 8.2 MB, 2.4 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaces = 24;     // two 12-triangle meshes
constexpr int kFaceWords = 16;  // p0(3) p1(3) p2(3) nh(3) S pad(3)

__device__ __forceinline__ float area(float u0, float u1, float u2, float v0,
                                      float v1, float v2) {
  const float w0 = u1 * v2 - u2 * v1;
  const float w1 = u2 * v0 - u0 * v2;
  const float w2 = u0 * v1 - u1 * v0;
  return sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
}

__device__ bool mesh_hit(const float* fv, float d0, float d1, float d2,
                         float o0, float o1, float o2) {
  bool any_hit = false;
  for (int f = 0; f < kFaces / 2; ++f) {
    const float* F = fv + f * kFaceWords;
    const float p00 = F[0], p01 = F[1], p02 = F[2];
    const float p10 = F[3], p11 = F[4], p12 = F[5];
    const float p20 = F[6], p21 = F[7], p22 = F[8];
    const float n0 = F[9], n1 = F[10], n2 = F[11];
    const float S = F[12];
    const float denom = n0 * d0 + n1 * d1 + n2 * d2 + 1e-12f;
    const float tnum = n0 * (p00 - o0) + n1 * (p01 - o1) + n2 * (p02 - o2);
    const float t = tnum / denom;
    const float ix = t * d0 + o0;
    const float iy = t * d1 + o1;
    const float iz = t * d2 + o2;
    const float a0 = ix - p00, a1 = iy - p01, a2 = iz - p02;
    const float b0 = ix - p10, b1 = iy - p11, b2 = iz - p12;
    const float c0 = ix - p20, c1 = iy - p21, c2 = iz - p22;
    const float bA = area(b0, b1, b2, c0, c1, c2);
    const float bB = area(c0, c1, c2, a0, a1, a2);
    const float bC = area(a0, a1, a2, b0, b1, b2);
    any_hit |= (bA > 0.f) & (bB > 0.f) & (bC > 0.f) & (bA + bB + bC <= S);
  }
  return any_hit;
}

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ u4, int C,
                const float* __restrict__ params,
                const float* __restrict__ fv_prep, float* __restrict__ cand,
                unsigned char* __restrict__ ok) {
  __shared__ float fv[kFaces * kFaceWords];
  __shared__ float prm[4];
  for (int k = threadIdx.x; k < kFaces * kFaceWords; k += kThreads)
    fv[k] = fv_prep[k];
  if (threadIdx.x < 4) prm[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= C) return;  // the col < C mask of the TPU kernel

  const float r = prm[0];
  const float pi = 3.14159265358979323846f;
  float q1[3], q2[3];
  {
    const float alpha = (u4[col] * 2.0f) * pi;
    const float u = u4[C + col] * 2.0f - 1.0f;
    const float s = sqrtf(fmaxf(1.0f - u * u, 0.0f));
    q1[0] = r * (s * static_cast<float>(cos(static_cast<double>(alpha))));
    q1[1] = r * (s * static_cast<float>(sin(static_cast<double>(alpha))));
    q1[2] = r * u;
  }
  {
    const float alpha = (u4[2 * C + col] * 2.0f) * pi;
    const float u = u4[3 * C + col] * 2.0f - 1.0f;
    const float s = sqrtf(fmaxf(1.0f - u * u, 0.0f));
    q2[0] = r * (s * static_cast<float>(cos(static_cast<double>(alpha))));
    q2[1] = r * (s * static_cast<float>(sin(static_cast<double>(alpha))));
    q2[2] = r * u;
  }
  float d0 = q2[0] - q1[0], d1 = q2[1] - q1[1], d2 = q2[2] - q1[2];
  const float norm = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float den = fmaxf(norm, 1e-12f);
  d0 = d0 / den;
  d1 = d1 / den;
  d2 = d2 / den;
  const float o0 = q1[0] + prm[1], o1 = q1[1] + prm[2], o2 = q1[2] + prm[3];

  // both meshes always, as the TPU kernel does: the work is data-independent
  const bool hit = mesh_hit(fv, d0, d1, d2, o0, o1, o2) &
                   mesh_hit(fv + (kFaces / 2) * kFaceWords, d0, d1, d2, o0,
                            o1, o2);
  float* out = cand + static_cast<size_t>(col) * 6;
  out[0] = d0; out[1] = d1; out[2] = d2;
  out[3] = o0; out[4] = o1; out[5] = o2;
  ok[col] = hit ? 1 : 0;
}

}  // namespace

// u4 (4, C); params [r, cx, cy, cz]; fv_prep (24, 16); outputs cand (C, 6)
// and ok (C,) bytes. All contiguous on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int arrl_resample(const float* u4, int C, const float* params,
                             const float* fv_prep, float* cand,
                             unsigned char* ok, void* stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  resample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u4, C, params, fv_prep, cand, ok);
  return static_cast<int>(cudaGetLastError());
}
