// The chamfer distance's nearest squared distances: for every point of
// either cloud of a pair, its least squared distance to the other cloud.
// Both directions of all B pairs in one launch, with no (B, M, N) matrix.
//
// Replaces no TPU kernel: the JAX package's chamfer distance is XLA's
// (a_robust_registration_loss_tpu/ops/geometry.py:261-271). The port's plain
// version (ops/geometry.py:chamfer_distance_reference) writes the (B, M, N)
// matrix of squared distances and reads it back five times: a GEMM, a
// scale, two broadcast adds and two amins. At the classical step's
// (1, 8,192, 8,192) that is a 268 MB matrix and about 2.4 GB of traffic,
// 0.75 to 1.1 ms of a 2.82 ms step, for a monitor whose inputs are 196 KB.
// This kernel takes its place for CUDA tensors.
//
// Arithmetic: the plain version's expansion, element by element,
//   d = (-2 (x.y) + |x|^2) + |y|^2,
// x the first cloud in both directions, the dot and the squares summed
// left to right over the three coordinates, every operation rounded on its
// own (-fmad=false, the _rn intrinsics). -2 (x.y) is taken as (-2x).y: a
// scaling by 2 is exact, so the two agree bit for bit unless a product is
// subnormal. The plain version's GEMM sums the dot in an order of cuBLAS's
// own, so the two differ by ulps of the terms; near coincident points
// either can go slightly negative.
// The minimum follows torch.amin: a NaN in a row makes its minimum NaN.
//
// Bound on the H100: operations. A (query, point) pair costs 8 fp32
// operations (3 multiplies, 4 adds, the minimum). Both directions at
// (1, 8,192, 8,192) are 134 M pairs, 1.07 G operations: 33.7 us at the
// 31.9 T ops/s that csrc/probe.cu measures without FMA. The inputs (196 KB)
// and the output (64 KB) are under 0.1 us at 3.35 TB/s, and stay in L2.
// The design keeps the loop at those 8 operations a pair and fills the card:
// - a thread holds one query in registers (-2x and |x|^2) with its running
//   minimum; a block of 256 threads sweeps a tile of 256 queries of one
//   direction of one sample;
// - the other cloud streams through shared memory in tiles of 256 points,
//   each a float4 (x, y, z, |y|^2): the thread that loads a point squares it
//   once for the whole block, and loads the next tile into registers while
//   the current one is swept (two buffers, one barrier a tile). Every thread
//   reads the same float4 (a broadcast);
// - the other cloud is split into S chunks, one block each, and the S blocks
//   form a thread block cluster: each leaves its partial minima in shared
//   memory, and after a cluster barrier the cluster's first block combines
//   them over the S blocks' shared memory (distributed shared memory), in
//   rank order, and writes them. No atomics, no scratch, no second launch,
//   no initialised output; every minimum is taken in a fixed order, so two
//   runs agree bit for bit;
// - S (1 to 8) is chosen from (B, M, N) and the SM count
//   (ops/cuda/chamfer.py:plan) for about two blocks an SM: at one block an
//   SM the sweep waits on latency. At (1, 8,192, 8,192) on 132 SMs, S = 4:
//   256 blocks, each 256 queries against a 2,048-point chunk;
// - clusters are placed by the load-balancing policy: under the default
//   placement the same plan took 81.5 us against 54.7 us (61% of the bound
//   above; H100 80GB HBM3, 700 W).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a block, and points a shared tile
constexpr int kMaxSplit = 8;   // the portable cluster size

// torch.amin's minimum: NaN where either is
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (a a + b b) + c c
__device__ __forceinline__ float norm2(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// Point j of a cloud as it is swept, (x, y, z, |p|^2); zeros past end
__device__ __forceinline__ float4 load_point(const float* __restrict__ p, int j, int end) {
  if (j >= end) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float a = p[3 * j], b = p[3 * j + 1], c = p[3 * j + 2];
  return make_float4(a, b, c, norm2(a, b, c));
}

// Lower the running minimum by the first count points of a shared tile.
// kFromX: the query is an x, and |x|^2 is added first, as the plain
// version adds the first cloud's squares first in both directions.
template <bool kFromX, bool kFull>
__device__ __forceinline__ void sweep(const float4* __restrict__ tile, int count, float qx,
                                      float qy, float qz, float qs, float& best) {
  const int n = kFull ? kThreads : count;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p = tile[j];
    const float dot =
        __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
    const float d = kFromX ? __fadd_rn(__fadd_rn(dot, qs), p.w)
                           : __fadd_rn(__fadd_rn(dot, p.w), qs);
    best = min_nan(best, d);
  }
}

// Sweep points [begin, end) of the other cloud through shared memory
template <bool kFromX>
__device__ __forceinline__ void sweep_chunk(float4 (&s_tile)[2][kThreads],
                                            const float* __restrict__ other, int begin,
                                            int end, float qx, float qy, float qz, float qs,
                                            float& best) {
  const int t = threadIdx.x;
  float4 next = load_point(other, begin + t, end);
  int buf = 0;
  for (int base = begin; base < end; base += kThreads) {
    // the buffer written here was last read before the previous barrier
    s_tile[buf][t] = next;
    __syncthreads();
    next = load_point(other, base + kThreads + t, end);
    const int count = min(kThreads, end - base);
    if (count == kThreads)
      sweep<kFromX, true>(s_tile[buf], count, qx, qy, qz, qs, best);
    else
      sweep<kFromX, false>(s_tile[buf], count, qx, qy, qz, qs, best);
    buf ^= 1;
  }
}

// x (B, m, 3), y (B, n, 3). Grid (split * (tiles_x + tiles_y), B): block
// (tile * split + rank, b) sweeps query tile `tile` (the first tiles_x of x
// against y, the rest of y against x) over chunk `rank` of the other cloud.
// Query i of x goes to out[b * stride_x + off_x + i], of y to
// out[b * stride_y + off_y + i].
__global__ void __launch_bounds__(kThreads, 2)
chamfer_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int m, int n, int split, int tiles_x,
               int64_t stride_x, int64_t off_x, int64_t stride_y, int64_t off_y) {
  __shared__ float4 s_tile[2][kThreads];
  __shared__ float s_best[kThreads];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int rank = static_cast<int>(blockIdx.x) % split;  // the block's rank in its cluster
  int tile = static_cast<int>(blockIdx.x) / split;
  const bool from_x = tile < tiles_x;
  if (!from_x) tile -= tiles_x;
  const int n_query = from_x ? m : n, n_other = from_x ? n : m;
  const float* query = from_x ? x + b * m * 3 : y + b * n * 3;
  const float* other = from_x ? y + b * n * 3 : x + b * m * 3;
  float* dst = out + (from_x ? b * stride_x + off_x : b * stride_y + off_y);

  // the thread's query, as -2 x and |x|^2
  const int i = tile * kThreads + t;
  const float4 p = load_point(query, i, n_query);
  const float qx = __fmul_rn(-2.f, p.x), qy = __fmul_rn(-2.f, p.y), qz = __fmul_rn(-2.f, p.z);
  float best = __int_as_float(0x7f800000);  // +inf

  const int chunk = (n_other + split - 1) / split;
  const int begin = min(n_other, rank * chunk), end = min(n_other, begin + chunk);
  if (from_x)
    sweep_chunk<true>(s_tile, other, begin, end, qx, qy, qz, p.w, best);
  else
    sweep_chunk<false>(s_tile, other, begin, end, qx, qy, qz, p.w, best);

  if (split == 1) {
    if (i < n_query) dst[i] = best;
    return;
  }
  s_best[t] = best;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    float v = best;
    for (int r = 1; r < split; ++r) v = min_nan(v, cluster.map_shared_rank(&s_best[0], r)[t]);
    if (i < n_query) dst[i] = v;
  }
  cluster.sync();  // keep this block's shared memory until the first has read it
}

cudaError_t launch(const float* x, const float* y, float* out, int B, int m, int n, int split,
                   int64_t stride_x, int64_t off_x, int64_t stride_y, int64_t off_y,
                   cudaStream_t s) {
  const int tiles_x = (m + kThreads - 1) / kThreads, tiles_y = (n + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * (tiles_x + tiles_y), B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 2 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, chamfer_kernel, x, y, out, m, n, split,
                                           tiles_x, stride_x, off_x, stride_y, off_y);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// x (B, m, 3) and y (B, n, 3) contiguous fp32 on the device, out on the
// device: x's minima at out[b * stride_x + off_x + i], y's at
// out[b * stride_y + off_y + i]. split: 1 to 8 blocks (a cluster) over the
// other cloud. Returns a CUDA error code, 0 when the launch was taken.
extern "C" int arrl_chamfer(const float* x, const float* y, float* out, int B, int m, int n,
                            int split, int64_t stride_x, int64_t off_x, int64_t stride_y,
                            int64_t off_y, void* stream) {
  if (split < 1 || split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(x, y, out, B, m, n, split, stride_x, off_x, stride_y, off_y,
                                 static_cast<cudaStream_t>(stream)));
}
