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
// Bound on the H100: operations. Per (line, neighbourhood) pair 3 x 16 fp32
// operations (3 sub, 3 + 3 mul and 2 + 2 add for d_ac and proj, then mul, sub,
// compare), plus 33 per stored slot in RECON mode; none of them is a fused
// multiply-add, so the reachable rate is the card's fp32 instruction rate, which
// ops/cuda/probe.py measures, not the data sheet's FMA-counted 67 TFLOP/s.
// The bytes (inputs once, outputs once) are far smaller: chip_smoke.py prints
// both bounds beside the measured time. Tensor cores are no way: the hit test
// has no margin, so the per-component rounding order is the result. What the
// design can do is fill every scheduler evenly and spend the instruction slots on
// those 48 operations.
//
// Design: a block of 4 warps takes 64 lines of one (sample, cloud) and
// splits the faces into 4 segments in ascending order: warp w sweeps segment
// w for two groups of 32 lines, a thread holding one line of each (a face's
// three loads then serve 96 operations). At the classical shape
// (20,000 lines, two clouds) whole-range warps of 32 lines are 1,250 tasks
// for the card's 528 schedulers, 2.4 each, and the schedulers with 3 set the
// time; split 4 ways the tasks are short and even out.
//
// The sweep. Faces stream through shared memory in steps of 64 faces a
// segment, padded to 12 words (9 coordinates, thr2, 2 unused) so that a face
// is three 128-bit loads, every lane of a warp reading the same face (a
// broadcast). The steps are double-buffered: the words of step t + 1 are
// copied with cp.async while step t is swept, one barrier a step. A face
// past the end of the cloud gets thr2 = -inf and never hits. The sweep body
// is the same for every mode and stores nothing to global memory: a thread
// keeps its count in a register and the first kmax hit indices of its
// (line, segment) in shared memory; hits are rare, so the body tests 4
// faces and branches once for them.
//
// The merge and the payload. After the sweep, thread (line, slot k) walks
// the line's segment counts in ascending segment order: the slot comes from
// the first segment whose running count passes k, the line's count is the
// sum, exactly the unsplit sweep's result. It then reads the stored face
// again (L2-resident) and forms d2 / recon / pts there, d2 through the same
// line_d2() the sweep used on the same inputs, so the bits cannot differ.
// Only this epilogue depends on the mode; the modes and the cloud count are
// template parameters, and the instantiations are named stage1_kernel<NC,
// D2, RECON, PTS> in a profile. A thread forms the recon weights only for
// a slot it stores; the TPU kernel forms them for every (face, line) and
// selects with a one-hot, which gives the same values.
//
// Numerics: built with -fmad=false, IEEE division and square root, so every
// multiply and add rounds on its own, as in the XLA/Pallas arithmetic; every
// output equals the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSegments = kWarps;  // face segments of a cloud, a warp each
constexpr int kStepFaces = 256;  // faces of all segments swept between two barriers
constexpr int kSegFaces = kStepFaces / kSegments;  // faces a segment sweeps in a step
constexpr int kFaceWords = 12;   // 9 neighbour coordinates + thr2 + 2 unused
constexpr int kNnei = 3;
constexpr int kLpt = 2;          // lines a thread sweeps: a face's loads serve 96 operations
constexpr int kUnroll = 4;       // faces of the sweep's unrolled body
static_assert(kSegFaces % kUnroll == 0, "a segment's step is whole unrolled bodies");

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

struct Line {
  float dx, dy, dz, ox, oy, oz;
};

__device__ __forceinline__ Line load_line(const float* ln) {
  return Line{ln[0], ln[1], ln[2], ln[3], ln[4], ln[5]};
}

// The squared distance of p from the line, less nothing: the one place
// where it is formed, for the sweep's test and for the payload alike.
__device__ __forceinline__ float line_d2(float px, float py, float pz, const Line& l) {
  const float ax = px - l.ox;
  const float ay = py - l.oy;
  const float az = pz - l.oz;
  float d_ac = ax * ax;
  d_ac = d_ac + ay * ay;
  d_ac = d_ac + az * az;
  float proj = ax * l.dx;
  proj = proj + ay * l.dy;
  proj = proj + az * l.dz;
  return d_ac - proj * proj;
}

__device__ __forceinline__ void copy_word_async(float* dst_shared, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Start the copies of one step's faces, kSegFaces of each segment, into buf
// ((kSegments, kSegFaces, kFaceWords) floats): segment s's are the faces
// from s * seg_len + step * kSegFaces. A thread copies whole faces, word by word (a
// face's 9 coordinates start at a multiple of 36 bytes, so 4 bytes is the
// widest copy that is always aligned). A face at or past F gets thr2 = -inf
// instead.
__device__ __forceinline__ void start_step(float* buf, const float* __restrict__ neis,
                                           const float* __restrict__ thr, int F,
                                           int seg_len, int step) {
  for (int fi = threadIdx.x; fi < kStepFaces; fi += kThreads) {
    const int s = fi / kSegFaces;
    const int f = s * seg_len + step * kSegFaces + (fi - s * kSegFaces);
    float* dst = buf + fi * kFaceWords;
    if (f < F) {
      const float* src = neis + static_cast<size_t>(f) * 9;
#pragma unroll
      for (int q = 0; q < 3 * kNnei; ++q) copy_word_async(dst + q, src + q);
      copy_word_async(dst + 3 * kNnei, thr + f);
    } else {
      dst[3 * kNnei] = -CUDART_INF_F;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int NC, bool D2, bool RECON, bool PTS>
__global__ void __launch_bounds__(kThreads, 8) stage1_kernel(const Stage1Args a) {
  extern __shared__ float4 shared_f4[];
  const int L = a.L, kmax = a.kmax;
  float* tiles = reinterpret_cast<float*>(shared_f4);  // (2, kSegments, kSegFaces, kFaceWords)
  int* seg_count = reinterpret_cast<int*>(tiles + 2 * kStepFaces * kFaceWords);  // (kThreads)
  int* seg_hits = seg_count + kLpt * kThreads;  // (kLpt, kmax, kThreads)

  const int cloud = NC == 2 ? static_cast<int>(blockIdx.y) : 0;
  const int b = blockIdx.z;
  const int F = cloud ? a.F1 : a.F0;
  const float* __restrict__ neis = (cloud ? a.neis1 : a.neis0) + static_cast<size_t>(b) * F * 9;
  const float* __restrict__ thr = (cloud ? a.thr1 : a.thr0) + static_cast<size_t>(b) * F;
  const float* __restrict__ lines = a.lines + static_cast<size_t>(b) * L * 6;

  const int tid = threadIdx.x, lane = tid & 31, seg = tid >> 5;
  // the block's lines are kLpt groups of LB; thread s * LB + lr has segment s
  // and line lr of each group
  constexpr int LB = 32;
  const int line0 = blockIdx.x * LB * kLpt;
  const int l = line0 + lane;
  Line ln[kLpt];
#pragma unroll
  for (int p = 0; p < kLpt; ++p) {
    ln[p] = Line{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (l + p * LB < L) ln[p] = load_line(lines + static_cast<size_t>(l + p * LB) * 6);
  }

  // segments of whole steps, so that every warp makes the same steps
  const int seg_len =
      ((F + kSegments - 1) / kSegments + kSegFaces - 1) / kSegFaces * kSegFaces;
  const int nsteps = seg_len / kSegFaces;
  int cnt[kLpt] = {};
  if (nsteps > 0) start_step(tiles, neis, thr, F, seg_len, 0);
  for (int t = 0; t < nsteps; ++t) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // step t has landed, and no warp still reads step t - 1
    if (t + 1 < nsteps)
      start_step(tiles + ((t + 1) & 1) * kStepFaces * kFaceWords, neis, thr, F, seg_len, t + 1);
    const int f0 = seg * seg_len + t * kSegFaces;
    if (f0 >= F) continue;  // the whole warp: its segment has ended
    const float4* T = reinterpret_cast<const float4*>(
        tiles + ((t & 1) * kStepFaces + seg * kSegFaces) * kFaceWords);
    for (int f4 = 0; f4 < kSegFaces; f4 += kUnroll) {
      bool hit[kLpt][kUnroll];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int f = f4 + j;
        const float4 u = T[3 * f], v = T[3 * f + 1], w = T[3 * f + 2];
#pragma unroll
        for (int p = 0; p < kLpt; ++p) {
          const float e0 = line_d2(u.x, u.y, u.z, ln[p]);
          const float e1 = line_d2(u.w, v.x, v.y, ln[p]);
          const float e2 = line_d2(v.z, v.w, w.x, ln[p]);
          hit[p][j] = (e0 < w.y) & (e1 < w.y) & (e2 < w.y);
          any |= hit[p][j];
        }
      }
      if (any) {  // rare: one branch for the kUnroll faces
#pragma unroll
        for (int p = 0; p < kLpt; ++p)
#pragma unroll
          for (int j = 0; j < kUnroll; ++j)
            if (hit[p][j]) {
              if (cnt[p] < kmax) seg_hits[(p * kmax + cnt[p]) * kThreads + tid] = f0 + f4 + j;
              ++cnt[p];
            }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kLpt; ++p) seg_count[p * kThreads + tid] = cnt[p];
  __syncthreads();

  // merge in segment order and write the payload: a thread per (line, slot)
  for (int i = tid; i < kLpt * LB * kmax; i += kThreads) {
    const int ll = i / kmax, k = i - ll * kmax;
    if (line0 + ll >= L) break;
    const int p = ll / LB, lr = ll - p * LB;
    int total = 0, f = -1;
    for (int s = 0; s < kSegments; ++s) {
      const int c = seg_count[p * kThreads + s * LB + lr];
      if (f < 0 && k < total + c) f = seg_hits[(p * kmax + k - total) * kThreads + s * LB + lr];
      total += c;
    }
    const size_t row = (static_cast<size_t>(b) * NC + cloud) * L + line0 + ll;
    const size_t slot = row * kmax + k;
    if (k == 0) a.count[row] = total;
    const bool filled = f >= 0;
    a.slot_idx[slot] = filled ? f : 0;
    if (D2 || RECON || PTS) {
      float P[3 * kNnei];
#pragma unroll
      for (int q = 0; q < 3 * kNnei; ++q)
        P[q] = filled ? neis[static_cast<size_t>(f) * 9 + q] : 0.f;
      if (PTS) {
#pragma unroll
        for (int q = 0; q < 3 * kNnei; ++q) a.slot_pts[slot * (3 * kNnei) + q] = P[q];
      }
      if (D2 || RECON) {
        float d2[kNnei] = {0.f, 0.f, 0.f};
        float recon[3] = {0.f, 0.f, 0.f};
        if (filled) {
          const Line own = load_line(lines + static_cast<size_t>(line0 + ll) * 6);
#pragma unroll
          for (int i3 = 0; i3 < kNnei; ++i3)
            d2[i3] = line_d2(P[3 * i3], P[3 * i3 + 1], P[3 * i3 + 2], own);
          if (RECON) {
            float d[kNnei];
#pragma unroll
            for (int i3 = 0; i3 < kNnei; ++i3) d[i3] = sqrtf(fmaxf(d2[i3] + 2e-4f, 0.f));
            float dsum = d[0];
#pragma unroll
            for (int i3 = 1; i3 < kNnei; ++i3) dsum = dsum + d[i3];
            const float dinv = 1.f / dsum;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float acc = 0.f;
#pragma unroll
              for (int i3 = 0; i3 < kNnei; ++i3) acc = acc + (d[i3] * dinv) * P[3 * i3 + c];
              recon[c] = acc;
            }
          }
        }
        if (D2) {
#pragma unroll
          for (int i3 = 0; i3 < kNnei; ++i3) a.slot_d2[slot * kNnei + i3] = d2[i3];
        }
        if (RECON) {
#pragma unroll
          for (int c = 0; c < 3; ++c) a.slot_recon[slot * 3 + c] = recon[c];
        }
      }
    }
  }
}

template <int NC, bool D2, bool RECON, bool PTS>
cudaError_t launch_one(dim3 grid, size_t shared, cudaStream_t stream, const Stage1Args& a) {
  if (shared > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(stage1_kernel<NC, D2, RECON, PTS>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(shared));
    if (rc != cudaSuccess) return rc;
  }
  stage1_kernel<NC, D2, RECON, PTS><<<grid, kThreads, shared, stream>>>(a);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch(int mode, dim3 grid, size_t shared, cudaStream_t stream,
                   const Stage1Args& a) {
  // mode bits: 1 = D2, 2 = RECON, 4 = PTS
  switch (mode) {
    case 0: return launch_one<NC, false, false, false>(grid, shared, stream, a);
    case 1: return launch_one<NC, true, false, false>(grid, shared, stream, a);
    case 2: return launch_one<NC, false, true, false>(grid, shared, stream, a);
    case 3: return launch_one<NC, true, true, false>(grid, shared, stream, a);
    case 4: return launch_one<NC, false, false, true>(grid, shared, stream, a);
    case 5: return launch_one<NC, true, false, true>(grid, shared, stream, a);
    case 6: return launch_one<NC, false, true, true>(grid, shared, stream, a);
    case 7: return launch_one<NC, true, true, true>(grid, shared, stream, a);
    default: return cudaErrorInvalidValue;
  }
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
                           int kmax, int* count, int* slot_idx,
                           float* slot_d2, float* slot_recon, float* slot_pts,
                           void* stream) {
  const Stage1Args a{lines, neis0, thr0, neis1, thr1, L, F0, F1, kmax,
                     count, slot_idx, slot_d2, slot_recon, slot_pts};
  const int block_lines = kLpt * kThreads / kSegments;
  const dim3 grid((L + block_lines - 1) / block_lines, n_cloud, B);
  const size_t shared = sizeof(float) * 2 * kStepFaces * kFaceWords +
                        sizeof(int) * kLpt * kThreads * (static_cast<size_t>(kmax) + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cloud == 1) return static_cast<int>(launch<1>(mode, grid, shared, s, a));
  if (n_cloud == 2) return static_cast<int>(launch<2>(mode, grid, shared, s, a));
  return static_cast<int>(cudaErrorInvalidValue);
}
