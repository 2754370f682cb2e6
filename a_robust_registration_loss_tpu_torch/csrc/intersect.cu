// Stage-1 sweep of the robust metric, every output mode, one or two clouds,
// with a batch axis.
//
// Replaces the TPU kernel a_robust_registration_loss_tpu/ops/pallas/
// intersect.py:_kernel in each combination of emit_d2, emit_recon and
// emit_pts, as launched by intersect_stage1 (one cloud), intersect_stage1_pair
// and _pair_call / intersect_stage1_pair_lanemajor (two clouds). For each
// sample, cloud and line it tests every neighbourhood:
//   d2_i = |p_i - x0|^2 - ((p_i - x0) . dir)^2 for each of the 3 neighbours,
//   accumulated one component at a time from the first product;
//   hit iff d2_i < thr2 for all i, thr2 = (delta * 1.731/2)^2 - 2e-4.
// It emits the uncapped hit count per line and, for the first kmax hit faces
// in ascending face order, their index and, by mode,
//   D2:    the raw d2_i of the 3 neighbours (no +2e-4);
//   RECON: the weighted reconstruction sum_i w_i p_i, w_i = d_i * (1 / sum d),
//          d_i = sqrt(max(d2_i + 2e-4, 0)): one reciprocal and 3 multiplies,
//          the sum started from 0, as the TPU kernel forms it;
//   PTS:   the 9 neighbour coordinates.
// Empty slots hold 0. Nothing O(L*F) is ever written.
//
// Design: one thread per (sample, cloud, line), grid (ceil(L/128), clouds, B).
// Faces stream through shared memory in ascending tiles of TF faces x 10
// floats (9 coordinates + thr2); every thread of the block reads the same face
// at the same time, a broadcast. A thread keeps its count in a register and
// stores a hit face straight into its next output slot while count < kmax, so
// no rank or prefix sum is needed: the walk is in face order. A thread forms
// the recon weights only for a face it stores; the TPU kernel forms them for
// every (face, line) and selects with a one-hot, which gives the same values.
// The modes and the cloud count are template parameters, so a mode that is
// off costs nothing; the instantiations are named stage1_kernel<NC, D2,
// RECON, PTS> in a profile.
//
// Numerics: built with -fmad=false, IEEE division and square root, so every
// multiply and add rounds on its own, as in the XLA/Pallas arithmetic; every
// output equals the plain PyTorch version's bit for bit.
//
// Bound on the H100: operations. Per (line, neighbourhood) pair 3 x 16 fp32
// operations (3 sub, 3 + 3 mul and 2 + 2 add for d_ac and proj, then mul, sub,
// compare), plus 33 per stored slot in RECON mode; none of them is a fused
// multiply-add, so the reachable rate is the card's fp32 instruction rate, which
// ops/cuda/probe.py measures, not the data sheet's FMA-counted 67 TFLOP/s.
// The bytes (inputs once, outputs once) are far smaller: chip_smoke.py prints
// both bounds beside the measured time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFaces = 256;
constexpr int kFaceWords = 10;  // 9 neighbour coordinates + thr2
constexpr int kNnei = 3;

struct Stage1Args {
  const float* lines;  // (B, L, 6)
  const float* neis0;  // (B, F0, 9)
  const float* thr0;   // (B, F0)
  const float* neis1;  // (B, F1, 9), two-cloud launches only
  const float* thr1;   // (B, F1)
  int L, F0, F1, kmax;
  int* count;          // (B, NC, L)
  int* slot_idx;       // (B, NC, L, kmax)
  float* slot_d2;      // (B, NC, L, kmax, 3)
  float* slot_recon;   // (B, NC, L, kmax, 3)
  float* slot_pts;     // (B, NC, L, kmax, 3, 3)
};

template <int NC, bool D2, bool RECON, bool PTS>
__global__ void __launch_bounds__(kThreads) stage1_kernel(const Stage1Args a) {
  __shared__ float tile[kTileFaces * kFaceWords];
  const int cloud = NC == 2 ? static_cast<int>(blockIdx.y) : 0;
  const int b = blockIdx.z;
  const int F = cloud ? a.F1 : a.F0;
  const float* __restrict__ neis = (cloud ? a.neis1 : a.neis0) + static_cast<size_t>(b) * F * 9;
  const float* __restrict__ thr = (cloud ? a.thr1 : a.thr0) + static_cast<size_t>(b) * F;
  const int L = a.L;
  const int kmax = a.kmax;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool live = l < L;

  float dx = 0.f, dy = 0.f, dz = 0.f, ox = 0.f, oy = 0.f, oz = 0.f;
  if (live) {
    const float* ln = a.lines + (static_cast<size_t>(b) * L + l) * 6;
    dx = ln[0]; dy = ln[1]; dz = ln[2];
    ox = ln[3]; oy = ln[4]; oz = ln[5];
  }
  const size_t row = (static_cast<size_t>(b) * NC + cloud) * L + l;
  int* idx_out = a.slot_idx + row * kmax;
  float* d2_out = D2 ? a.slot_d2 + row * kmax * kNnei : nullptr;
  float* r_out = RECON ? a.slot_recon + row * kmax * 3 : nullptr;
  float* pts_out = PTS ? a.slot_pts + row * kmax * (3 * kNnei) : nullptr;
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
      float d2[kNnei];
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
        d2[i] = d_ac - proj * proj;
        hit = hit & (d2[i] < t2);
      }
      if (hit) {
        if (cnt < kmax) {
          idx_out[cnt] = f0 + f;
          if (D2) {
#pragma unroll
            for (int i = 0; i < kNnei; ++i) d2_out[cnt * kNnei + i] = d2[i];
          }
          if (RECON) {
            float d[kNnei];
#pragma unroll
            for (int i = 0; i < kNnei; ++i) d[i] = sqrtf(fmaxf(d2[i] + 2e-4f, 0.f));
            float dsum = d[0];
#pragma unroll
            for (int i = 1; i < kNnei; ++i) dsum = dsum + d[i];
            const float dinv = 1.f / dsum;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float acc = 0.f;
#pragma unroll
              for (int i = 0; i < kNnei; ++i) acc = acc + (d[i] * dinv) * P[3 * i + c];
              r_out[cnt * 3 + c] = acc;
            }
          }
          if (PTS) {
#pragma unroll
            for (int q = 0; q < 3 * kNnei; ++q) pts_out[cnt * 3 * kNnei + q] = P[q];
          }
        }
        ++cnt;
      }
    }
  }
  if (!live) return;
  a.count[row] = cnt;
  for (int s = min(cnt, kmax); s < kmax; ++s) {
    idx_out[s] = 0;
    if (D2) {
#pragma unroll
      for (int i = 0; i < kNnei; ++i) d2_out[s * kNnei + i] = 0.f;
    }
    if (RECON) {
#pragma unroll
      for (int c = 0; c < 3; ++c) r_out[s * 3 + c] = 0.f;
    }
    if (PTS) {
#pragma unroll
      for (int q = 0; q < 3 * kNnei; ++q) pts_out[s * 3 * kNnei + q] = 0.f;
    }
  }
}

template <int NC>
cudaError_t launch(int mode, dim3 grid, cudaStream_t stream, const Stage1Args& a) {
  // mode bits: 1 = D2, 2 = RECON, 4 = PTS
  switch (mode) {
    case 0: stage1_kernel<NC, false, false, false><<<grid, kThreads, 0, stream>>>(a); break;
    case 1: stage1_kernel<NC, true, false, false><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: stage1_kernel<NC, false, true, false><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: stage1_kernel<NC, true, true, false><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: stage1_kernel<NC, false, false, true><<<grid, kThreads, 0, stream>>>(a); break;
    case 5: stage1_kernel<NC, true, false, true><<<grid, kThreads, 0, stream>>>(a); break;
    case 6: stage1_kernel<NC, false, true, true><<<grid, kThreads, 0, stream>>>(a); break;
    case 7: stage1_kernel<NC, true, true, true><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// n_cloud 1 or 2; mode bits 1 = emit_d2, 2 = emit_recon, 4 = emit_pts.
// lines (B, L, 6); neis_c (B, F_c, 9) and thr_c (B, F_c) per cloud (the
// second pair ignored when n_cloud is 1); outputs count (B, n_cloud, L),
// slot_idx (B, n_cloud, L, kmax) and, for the modes that are on, slot_d2 and
// slot_recon (B, n_cloud, L, kmax, 3), slot_pts (B, n_cloud, L, kmax, 3, 3);
// a mode that is off may pass a null pointer. All contiguous fp32 / int32 on
// the device. Returns cudaGetLastError() after the launch.
extern "C" int arrl_stage1(int n_cloud, int mode, const float* lines, int B,
                           int L, const float* neis0, const float* thr0, int F0,
                           const float* neis1, const float* thr1, int F1,
                           int kmax, int* count, int* slot_idx, float* slot_d2,
                           float* slot_recon, float* slot_pts, void* stream) {
  const Stage1Args a{lines, neis0, thr0, neis1, thr1, L, F0, F1, kmax,
                     count, slot_idx, slot_d2, slot_recon, slot_pts};
  const dim3 grid((L + kThreads - 1) / kThreads, n_cloud, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cloud == 1) return static_cast<int>(launch<1>(mode, grid, s, a));
  if (n_cloud == 2) return static_cast<int>(launch<2>(mode, grid, s, a));
  return static_cast<int>(cudaErrorInvalidValue);
}
