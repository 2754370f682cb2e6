// Farthest-point sampling: npoint greedy picks from each of B clouds, one
// block per cloud and one launch per call.
//
// Replaces no TPU kernel: the JAX package runs FPS as a lax.fori_loop that
// XLA compiles (a_robust_registration_loss_tpu/ops/geometry.py:41-70). The
// port's plain version (ops/geometry.py:farthest_point_sample_reference) is
// a Python loop of npoint steps of about 7 small launches each, paced by
// the host; this kernel takes its place for CUDA tensors.
//
// Pick i writes the current index, then every point's running minimum
// distance to the picks so far is lowered by its distance to that pick, and
// the next index is the argmax of the minima. The indices equal the plain
// version's on the card bit for bit:
// - the distance rounds as PyTorch's kernels do: d = x - c per axis, each
//   square one rounded multiply, and the sum of the last axis as the card's
//   reduction takes three values, (dx^2 + dz^2) + dy^2 (two lanes, the
//   first holding elements 0 and 2); every operation by its _rn intrinsic,
//   so nothing contracts;
// - the minimum starts at 1e10 and follows torch.minimum: a NaN on either
//   side gives NaN (min.NaN), an equal value is the same value;
// - the argmax follows torch.argmax: NaN ranks above every number, ties go
//   to the lower index, at every level of the reduction. A minimum is never
//   negative, so its bits, read as an unsigned integer, rank as its value
//   does, the canonical NaN above all.
// An out-of-range start index fails the launch, as the plain version's
// indexing does; a negative one counts from the end.
//
// Bound on the H100: the latency of npoint dependent iterations. The work,
// 10 fp32 operations a point and pick and the cloud's bytes read once, is
// microseconds (13 us at 8,192 points and 5,000 picks); each iteration
// waits on a block-wide argmax before the next can start. The design meets
// that with one block per cloud and one barrier an iteration: the block's
// 1,024 threads hold up to 8 points each (clouds of up to 8,192 points) in
// registers, coordinates and running minima, for the whole loop, with a
// copy of the coordinates in shared memory for the picked centroid, so the
// loop makes no global round trip. A warp's argmax is two redux.sync
// instructions (the largest key, then the lowest index that holds it); the
// warps' winners go through shared memory (double-buffered by parity, so one
// barrier suffices), and every warp reduces the 32 winners itself. Larger
// clouds take the same kernel with a strided loop over points streamed
// from global memory (the L2), their minima in a scratch buffer.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                       // points a thread holds
constexpr int kOnChipMax = kThreads * kPerThread;   // 8,192
constexpr float kFar = 1e10f;                       // the minima's start
constexpr unsigned kNone = 0xffffffffu;             // no point

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy));
}

// torch.minimum(m, d): NaN where either is, as the canonical NaN
__device__ __forceinline__ float min_nan(float m, float d) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(d));
  return r;
}

// A running minimum as the argmax's key: it is never negative (a sum of
// squares, or 1e10) or it is the canonical NaN, so its bits order as
// torch.argmax ranks: NaN above every number.
__device__ __forceinline__ unsigned key_of(float m) { return __float_as_uint(m); }

// The warp's first (key, index): the largest key, then the lowest index
// that holds it. A lane with no point holds (0, kNone) and loses to any
// point.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == top ? idx : kNone);
  key = top;
}

// xyz (B, n, 3), start (B,) or null, out (B, npoint); minima (B, n) scratch
// on the streamed path. Dynamic shared memory: 3 n floats on chip.
template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const int64_t* __restrict__ start,
           int64_t* __restrict__ out, float* __restrict__ minima, int n,
           int npoint) {
  extern __shared__ float s_cloud[];  // x[n], y[n], z[n]
  __shared__ unsigned s_key[2][kWarps], s_idx[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int64_t* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  float* mins = kOnChip ? nullptr : minima + static_cast<size_t>(blockIdx.x) * n;

  const int64_t first = start ? start[blockIdx.x] : 0;
  assert(first >= -n && first < n);
  int far = static_cast<int>(first < 0 ? first + n : first);

  float px[kPerThread], py[kPerThread], pz[kPerThread], m[kPerThread];
  if (kOnChip) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = t + k * kThreads;
      m[k] = kFar;
      if (j < n) {
        px[k] = p[3 * j];
        py[k] = p[3 * j + 1];
        pz[k] = p[3 * j + 2];
        s_cloud[j] = px[k];
        s_cloud[n + j] = py[k];
        s_cloud[2 * n + j] = pz[k];
      }
    }
    __syncthreads();
  }

  for (int it = 0; it < npoint; ++it) {
    if (t == 0) o[it] = it == 0 ? first : far;
    float cx, cy, cz;
    if (kOnChip) {
      cx = s_cloud[far];
      cy = s_cloud[n + far];
      cz = s_cloud[2 * n + far];
    } else {
      cx = p[3 * far];
      cy = p[3 * far + 1];
      cz = p[3 * far + 2];
    }
    // the thread's first (key, index): its points in ascending index, a
    // later one taken only on a larger key
    unsigned key = 0, idx = kNone;
    if (kOnChip) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int j = t + k * kThreads;
        if (j < n) {
          m[k] = min_nan(m[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
          const unsigned kj = key_of(m[k]);
          if (k == 0 || kj > key) {
            key = kj;
            idx = j;
          }
        }
      }
    } else {
      for (int j = t; j < n; j += kThreads) {
        const float mj = min_nan(it == 0 ? kFar : mins[j],
                                 sq_dist(p[3 * j], p[3 * j + 1], p[3 * j + 2], cx, cy, cz));
        mins[j] = mj;
        const unsigned kj = key_of(mj);
        if (j == t || kj > key) {
          key = kj;
          idx = j;
        }
      }
    }
    warp_argmax(key, idx);
    const int buf = it & 1;
    if (lane == 0) {
      s_key[buf][warp] = key;
      s_idx[buf][warp] = idx;
    }
    __syncthreads();
    key = s_key[buf][lane];
    idx = s_idx[buf][lane];
    warp_argmax(key, idx);
    far = static_cast<int>(idx);
  }
}

}  // namespace

// xyz (B, n, 3) contiguous fp32, start (B,) int64 or null for 0, out (B,
// npoint) int64, all on the device; minima (B, n) fp32 scratch where n >
// 8,192, else unused. Clouds of up to 8,192 points stay on chip. Returns
// cudaGetLastError() after the launch.
extern "C" int arrl_fps(const float* xyz, const int64_t* start, int64_t* out,
                        float* minima, int B, int n, int npoint, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= kOnChipMax) {
    const int smem = 3 * n * static_cast<int>(sizeof(float));
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fps_kernel<true><<<B, kThreads, smem, s>>>(xyz, start, out, minima, n, npoint);
  } else {
    fps_kernel<false><<<B, kThreads, 0, s>>>(xyz, start, out, minima, n, npoint);
  }
  return static_cast<int>(cudaGetLastError());
}
