// Paired stage-1 sweep of the robust metric, pts mode.
//
// Replaces the TPU kernel a_robust_registration_loss_tpu/ops/pallas/
// intersect.py:_kernel with emit_pts=True, launched through _pair_call /
// intersect_stage1_pair_lanemajor. For both clouds of a pair against one
// line set it tests every (line, neighbourhood) pair:
//   d2_i = |p_i - x0|^2 - ((p_i - x0) . dir)^2 for each of the 3 neighbours,
//   accumulated one component at a time from the first product;
//   hit iff d2_i < thr2 for all i, thr2 = (delta * 1.731/2)^2 - 2e-4.
// It emits the uncapped hit count per line, and the first kmax hit faces in
// ascending face order: their index and their 9 neighbour coordinates.
// Empty slots hold 0. Nothing O(L*F) is ever written.
//
// Design: one thread per (cloud, line), grid (ceil(L/128), 2). Faces stream
// through shared memory in ascending tiles of TF faces x 10 floats (9
// coordinates + thr2); every thread of the block reads the same face at the
// same time, a broadcast. A thread keeps its count in a register and stores
// a hit face straight into its next output slot while count < kmax, so no
// rank or prefix sum is needed: the walk is in face order.
//
// Numerics: built with -fmad=false, so every multiply and add rounds on its
// own, as in the XLA/Pallas arithmetic; the labels equal the plain PyTorch
// version's bit for bit.
//
// Bound on the H100: operations. Per pair 3 x 16 fp32 operations
// (3 sub, 3 + 3 mul and 2 + 2 add for d_ac and proj, then mul, sub,
// compare), 81.9 M pairs per step at F = 2,048 per cloud, L = 20,000:
// 3.93 G operations, 0.059 ms at the data sheet's 67 TFLOP/s; the ~2 MB in
// and out take under 1 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFaces = 256;
constexpr int kFaceWords = 10;  // 9 neighbour coordinates + thr2
constexpr int kNnei = 3;

__global__ void __launch_bounds__(kThreads)
stage1_pair_kernel(const float* __restrict__ lines, int L,
                   const float* __restrict__ neis1,
                   const float* __restrict__ thr1, int F1,
                   const float* __restrict__ neis2,
                   const float* __restrict__ thr2, int F2, int kmax,
                   int* __restrict__ count, int* __restrict__ slot_idx,
                   float* __restrict__ slot_pts) {
  __shared__ float tile[kTileFaces * kFaceWords];
  const int cloud = blockIdx.y;
  const float* __restrict__ neis = cloud ? neis2 : neis1;
  const float* __restrict__ thr = cloud ? thr2 : thr1;
  const int F = cloud ? F2 : F1;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool live = l < L;

  float dx = 0.f, dy = 0.f, dz = 0.f, ox = 0.f, oy = 0.f, oz = 0.f;
  if (live) {
    const float* ln = lines + static_cast<size_t>(l) * 6;
    dx = ln[0]; dy = ln[1]; dz = ln[2];
    ox = ln[3]; oy = ln[4]; oz = ln[5];
  }
  const size_t row = static_cast<size_t>(cloud) * L + l;
  int* idx_out = slot_idx + row * kmax;
  float* pts_out = slot_pts + row * kmax * (3 * kNnei);
  int cnt = 0;

  for (int f0 = 0; f0 < F; f0 += kTileFaces) {
    const int nf = min(kTileFaces, F - f0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < nf * kFaceWords; k += kThreads) {
      const int f = k / kFaceWords;
      const int q = k - f * kFaceWords;
      tile[k] = q < 3 * kNnei ? neis[static_cast<size_t>(f0 + f) * 9 + q]
                              : thr[f0 + f];
    }
    __syncthreads();
    if (!live) continue;
    for (int f = 0; f < nf; ++f) {
      const float* P = tile + f * kFaceWords;
      const float t2 = P[9];
      bool hit = true;
#pragma unroll
      for (int i = 0; i < kNnei; ++i) {
        const float ax = P[3 * i] - ox;
        const float ay = P[3 * i + 1] - oy;
        const float az = P[3 * i + 2] - oz;
        float d_ac = ax * ax;
        d_ac = d_ac + ay * ay;
        d_ac = d_ac + az * az;
        float proj = ax * dx;
        proj = proj + ay * dy;
        proj = proj + az * dz;
        const float d2 = d_ac - proj * proj;
        hit = hit & (d2 < t2);
      }
      if (hit) {
        if (cnt < kmax) {
          idx_out[cnt] = f0 + f;
#pragma unroll
          for (int q = 0; q < 3 * kNnei; ++q) pts_out[cnt * 3 * kNnei + q] = P[q];
        }
        ++cnt;
      }
    }
  }
  if (!live) return;
  count[row] = cnt;
  for (int s = min(cnt, kmax); s < kmax; ++s) {
    idx_out[s] = 0;
#pragma unroll
    for (int q = 0; q < 3 * kNnei; ++q) pts_out[s * 3 * kNnei + q] = 0.f;
  }
}

}  // namespace

// lines (L, 6); neis_c (F_c, 9) and thr_c (F_c,) per cloud; outputs count
// (2, L), slot_idx (2, L, kmax), slot_pts (2, L, kmax, 3, 3). All contiguous
// fp32 / int32 on the device. Returns cudaGetLastError() after the launch.
extern "C" int arrl_stage1_pair(const float* lines, int L, const float* neis1,
                                const float* thr1, int F1, const float* neis2,
                                const float* thr2, int F2, int kmax,
                                int* count, int* slot_idx, float* slot_pts,
                                void* stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, 2);
  stage1_pair_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lines, L, neis1, thr1, F1, neis2, thr2, F2, kmax, count, slot_idx,
      slot_pts);
  return static_cast<int>(cudaGetLastError());
}
