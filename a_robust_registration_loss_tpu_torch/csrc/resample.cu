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
// two builds, and one ulp in a direction moves the knife-edge labels). Every
// (candidate, face) test keeps its arithmetic; only which tests run, and in
// what order, is the design's. The outputs equal the plain version bit for
// bit.
//
// Bound on the H100: operations. Per candidate 16 bytes in and 25 out, and
// 1,990 fp32 operations for the function's full work (24 faces x 81, plus 46
// for the sphere points and the line; each cos/sin counted as one): at
// C = 200,000 that is 398 M operations, 12.4 us at the 32 T fp32 ops/s that
// FMA-free code reaches, against 8.2 MB, 2.4 us at 3.35 TB/s. What a count
// does not see: each IEEE square root (3 a face) and division (1 a face) is
// a MUFU op plus Newton steps and a special-case check, and the float64
// sin and cos run on the DP pipe.
//
// Design, for the work that decides a label:
// - The mesh tested first is mesh 2, the target's box, around which the
//   sampling sphere is built: on this system's data the less-hit mesh
//   (9.3% of the classical path's candidates, 47% of DCP's). ok = hit1 &
//   hit2 is exact and commutative, so mesh 1 is tested only for the
//   candidates that hit mesh 2: a block compacts their lines into shared
//   memory (a ballot per warp, one integer atomic per warp for its place in
//   the list; the order of the list changes no output) and then tests them
//   densely, a survivor a thread. 12 + p x 12 face tests per candidate in
//   place of 24. Where the survivors fill only a few warps (the classical
//   path: about 48 of a block's 512), the other warps idle in that pass.
//   Splitting the 12 faces over them, as a second code path for few
//   survivors, saved 0.7 us of 18 at C = 200,000; as the only path, whose
//   verdicts wait in shared memory behind one more barrier, it cost 4 us of
//   60 at B = 4 x 150,000, where the survivors fill the block.
// - A thread of the first pass takes kPer candidates: each face's 16 words
//   come from shared memory as four 128-bit loads that serve all of them,
//   and the candidates' chains interleave.
// - One sincos per angle: one range reduction for both values.
// - The grid: tiles of kTile candidates of one sample, grid y over the
//   batch. At C = 200,000 the 391 blocks are all resident at once (3 an SM,
//   which holds while a thread takes at most 85 registers), and at B = 4 x
//   150,000 the 1,172 blocks are handed out as earlier ones finish, so no
//   wave leaves SMs idle for long.
// Outputs: cand (B, C, 6) [direction | origin] and ok (B, C) as bytes 0/1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                 // candidates a thread takes in the first pass
constexpr int kTile = kThreads * kPer;  // candidates a block takes
constexpr int kFaces = 24;              // two 12-triangle meshes
constexpr int kMeshFaces = kFaces / 2;
constexpr int kFaceWords = 16;          // p0(3) p1(3) p2(3) nh(3) S pad(3)

__device__ __forceinline__ float area(float u0, float u1, float u2, float v0,
                                      float v1, float v2) {
  const float w0 = u1 * v2 - u2 * v1;
  const float w1 = u2 * v0 - u0 * v2;
  const float w2 = u0 * v1 - u1 * v0;
  return sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
}

// The barycentric test of one line against one face F, four float4 of
// shared memory: (p00 p01 p02 p10) (p11 p12 p20 p21) (p22 n0 n1 n2) (S - - -).
__device__ __forceinline__ bool face_hit(const float4& A, const float4& B,
                                         const float4& Cw, float S,
                                         const float (&d)[3],
                                         const float (&o)[3]) {
  const float p00 = A.x, p01 = A.y, p02 = A.z;
  const float p10 = A.w, p11 = B.x, p12 = B.y;
  const float p20 = B.z, p21 = B.w, p22 = Cw.x;
  const float n0 = Cw.y, n1 = Cw.z, n2 = Cw.w;
  const float denom = n0 * d[0] + n1 * d[1] + n2 * d[2] + 1e-12f;
  const float tnum = n0 * (p00 - o[0]) + n1 * (p01 - o[1]) + n2 * (p02 - o[2]);
  const float t = tnum / denom;
  const float ix = t * d[0] + o[0];
  const float iy = t * d[1] + o[1];
  const float iz = t * d[2] + o[2];
  const float a0 = ix - p00, a1 = iy - p01, a2 = iz - p02;
  const float b0 = ix - p10, b1 = iy - p11, b2 = iz - p12;
  const float c0 = ix - p20, c1 = iy - p21, c2 = iz - p22;
  const float bA = area(b0, b1, b2, c0, c1, c2);
  const float bB = area(c0, c1, c2, a0, a1, a2);
  const float bC = area(a0, a1, a2, b0, b1, b2);
  return (bA > 0.f) & (bB > 0.f) & (bC > 0.f) & (bA + bB + bC <= S);
}

// Any-hit of K lines against the mesh of 12 faces at F.
template <int K>
__device__ __forceinline__ void mesh_hit(const float4* F, const float (&d)[K][3],
                                         const float (&o)[K][3], bool (&hit)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) hit[k] = false;
#pragma unroll 2
  for (int f = 0; f < kMeshFaces; ++f) {
    const float4 A = F[4 * f], B = F[4 * f + 1], Cw = F[4 * f + 2];
    const float S = F[4 * f + 3].x;
#pragma unroll
    for (int k = 0; k < K; ++k) hit[k] |= face_hit(A, B, Cw, S, d[k], o[k]);
  }
}

__device__ __forceinline__ void sphere_point(float ua, float uu, float r,
                                             float (&q)[3]) {
  const float pi = 3.14159265358979323846f;
  const float alpha = (ua * 2.0f) * pi;
  const float u = uu * 2.0f - 1.0f;
  const float s = sqrtf(fmaxf(1.0f - u * u, 0.0f));
  double sn, cs;
  sincos(static_cast<double>(alpha), &sn, &cs);
  q[0] = r * (s * static_cast<float>(cs));
  q[1] = r * (s * static_cast<float>(sn));
  q[2] = r * u;
}

// Any-hit of survivor s of the compacted list against mesh 1.
__device__ __forceinline__ bool survivor_hit(const float4* fv, const float (*surv)[kTile],
                                             int s) {
  const float d[1][3] = {{surv[0][s], surv[1][s], surv[2][s]}};
  const float o[1][3] = {{surv[3][s], surv[4][s], surv[5][s]}};
  bool hit[1];
  mesh_hit<1>(fv, d, o, hit);
  return hit[0];
}

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ u4, int C,
                const float* __restrict__ params,
                const float* __restrict__ fv_prep, float* __restrict__ cand,
                unsigned char* __restrict__ ok) {
  __shared__ float4 fv[kFaces * kFaceWords / 4];
  __shared__ float surv[6][kTile];  // the lines that hit mesh 2, by component
  __shared__ int surv_col[kTile];
  __shared__ int n_surv;
  const size_t b = blockIdx.y;  // the sample
  u4 += b * 4 * C;
  params += b * 4;
  fv_prep += b * kFaces * kFaceWords;
  cand += b * C * 6;
  ok += b * C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int base = blockIdx.x * kTile;
  float* fvw = reinterpret_cast<float*>(fv);
  for (int k = tid; k < kFaces * kFaceWords; k += kThreads) fvw[k] = fv_prep[k];
  if (tid == 0) n_surv = 0;
  const float r = params[0];
  const float cen[3] = {params[1], params[2], params[3]};
  __syncthreads();

  // First pass: the lines of kPer candidates a thread, tested on mesh 2.
  float d[kPer][3], o[kPer][3];
  bool live[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = base + k * kThreads + tid;
    live[k] = col < C;  // the col < C mask of the TPU kernel
    float q1[3] = {0.f, 0.f, 0.f}, q2[3] = {0.f, 0.f, 0.f};
    if (live[k]) {
      sphere_point(u4[col], u4[C + col], r, q1);
      sphere_point(u4[2 * C + col], u4[3 * C + col], r, q2);
    }
    d[k][0] = q2[0] - q1[0];
    d[k][1] = q2[1] - q1[1];
    d[k][2] = q2[2] - q1[2];
    const float norm = sqrtf(d[k][0] * d[k][0] + d[k][1] * d[k][1] + d[k][2] * d[k][2]);
    const float den = fmaxf(norm, 1e-12f);
    d[k][0] = d[k][0] / den;
    d[k][1] = d[k][1] / den;
    d[k][2] = d[k][2] / den;
    o[k][0] = q1[0] + cen[0];
    o[k][1] = q1[1] + cen[1];
    o[k][2] = q1[2] + cen[2];
  }
  bool hit2[kPer];
  mesh_hit<kPer>(fv + kMeshFaces * kFaceWords / 4, d, o, hit2);

  // Write every line; compact the survivors' lines into shared memory.
  unsigned m[kPer];
  int n_warp = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    m[k] = __ballot_sync(0xffffffffu, live[k] && hit2[k]);
    n_warp += __popc(m[k]);
  }
  int at = 0;
  if (lane == 0 && n_warp) at = atomicAdd(&n_surv, n_warp);
  at = __shfl_sync(0xffffffffu, at, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = base + k * kThreads + tid;
    if (live[k]) {
      float* out = cand + static_cast<size_t>(col) * 6;
      out[0] = d[k][0]; out[1] = d[k][1]; out[2] = d[k][2];
      out[3] = o[k][0]; out[4] = o[k][1]; out[5] = o[k][2];
      if (!hit2[k]) ok[col] = 0;
    }
    if ((m[k] >> lane) & 1u) {
      const int p = at + __popc(m[k] & below);
      surv_col[p] = col;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        surv[j][p] = d[k][j];
        surv[3 + j][p] = o[k][j];
      }
    }
    at += __popc(m[k]);
  }
  __syncthreads();

  // Second pass: mesh 1 on the survivors, a survivor a thread.
  for (int s = tid; s < n_surv; s += kThreads)
    ok[surv_col[s]] = survivor_hit(fv, surv, s) ? 1 : 0;
}

}  // namespace

// u4 (B, 4, C); params (B, 4) rows [r, cx, cy, cz]; fv_prep (B, 24, 16);
// outputs cand (B, C, 6) and ok (B, C) bytes. All contiguous on the device;
// B <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int arrl_resample(const float* u4, int B, int C,
                             const float* params, const float* fv_prep,
                             float* cand, unsigned char* ok, void* stream) {
  const dim3 grid((C + kTile - 1) / kTile, B);
  resample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u4, C, params, fv_prep, cand, ok);
  return static_cast<int>(cudaGetLastError());
}
