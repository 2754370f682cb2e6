// Row gather and its gradient:
//   forward   out[b, q, :]    = table[b, idx[b, q], :]
//   backward  d_table[b, n, :] = sum over q with idx[b, q] == n of g[b, q, :]
//
// Replaces the TPU kernels a_robust_registration_loss_tpu/ops/pallas/
// gather.py:_fwd_kernel and _bwd_kernel (launched by _gather_fwd_impl and
// _gather_bwd_impl behind gather_rows). There the gather is a contraction
// with a one-hot selector on the matrix unit; a GPU addresses memory per
// thread, so the forward is a pure copy and the backward a segmented sum.
// What is kept is the one-hot's semantics: a row whose idx is < 0 or >= N
// comes out as zeros and its gradient is dropped.
//
// Forward: one thread per output vector (a float, or a float4 where C is a
// multiple of 4 and the pointers are 16-byte aligned), grid y over the
// batch. Threads of a warp write neighbouring addresses and read
// neighbouring addresses within a table row; the table is small and stays
// in L2. Bound: bytes (table and idx read once, out written once).
//
// Backward: deterministic, no atomics, two launches give equal bits. A block
// owns kRows table rows x kCols columns of one sample. It scans that
// sample's idx in chunks of kList queries, kPer consecutive queries per
// thread, and compacts the queries that fall into its rows into a list in
// shared memory, in ascending q (a prefix sum of the hit counts in thread
// order). Then it walks the list in pieces of kStage entries: all threads
// copy the pieces' g rows into shared memory (independent, coalesced
// loads, so the ordered part waits for no global load), and then the
// owners add, each finding its entries of the piece from a warp ballot.
// The block's threads form groups of cw (a power of two >=
// min(C, kCols)) threads, one per column; row r belongs to group r mod
// groups, so each (row, column) accumulator in shared memory has exactly
// one owner, which adds its g values in ascending q, starting from 0: the
// order of a sequential index_add. Every block scans all of idx, so the
// scan costs (N / kRows) * Q index reads per sample, from L2: fine for
// tables of a few thousand rows, the shapes this system has. Bound: bytes
// (g and idx read once, d_table written once).
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kRows = 32;    // table rows a backward block owns
constexpr int kCols = 128;   // columns a backward block owns
constexpr int kPer = 8;      // consecutive queries a thread scans per chunk
constexpr int kList = kPer * kBwdThreads;  // queries scanned per chunk
constexpr int kStage = 32;   // list entries whose g rows are staged at once
static_assert(kStage == 32, "the walk gives each lane of a warp one entry");
static_assert(kList <= 65536, "list_q holds q - q0 in 16 bits");

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V is float or float4; Cv is the row width in units of V.
template <typename I, typename V>
__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                  V* __restrict__ out, int N, unsigned Q, unsigned Cv) {
  const unsigned QCv = Q * Cv;
  const unsigned e = blockIdx.x * kFwdThreads + threadIdx.x;
  if (e >= QCv) return;
  const size_t b = blockIdx.y;
  const unsigned q = e / Cv;
  const unsigned c = e - q * Cv;
  const long long n = static_cast<long long>(idx[b * Q + q]);
  V v = zero_of(V());
  if (n >= 0 && n < N) v = table[(b * N + n) * Cv + c];
  out[b * QCv + e] = v;
}

template <typename I>
__global__ void __launch_bounds__(kBwdThreads)
gather_bwd_kernel(const float* __restrict__ g, const I* __restrict__ idx,
                  float* __restrict__ dtab, int N, int C, int Q, int cw) {
  __shared__ float acc[kRows * kCols];
  __shared__ float stage[kStage * kCols];
  __shared__ unsigned short list_q[kList];  // q - q0 of the chunk
  __shared__ unsigned char list_r[kList];
  __shared__ int warp_hits[kBwdThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.z;
  const long long n0 = static_cast<long long>(blockIdx.x) * kRows;
  const int c0 = blockIdx.y * kCols;
  const int ncol = min(C - c0, kCols);  // the columns this block owns
  const int groups = kBwdThreads / cw;  // cw and groups are powers of two
  const int grp = tid / cw;
  const int c = tid - grp * cw;
  const bool col_ok = c < ncol;

  for (int k = tid; k < kRows * kCols; k += kBwdThreads) acc[k] = 0.f;
  const I* idx_b = idx + b * Q;
  const float* g_b = g + b * Q * C + c0;

  for (int q0 = 0; q0 < Q; q0 += kList) {
    // scan: thread t takes the kPer consecutive queries from q0 + kPer * t,
    // so thread order is query order
    const int qb = q0 + tid * kPer;
    int rows[kPer];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      rows[u] = -1;
      if (qb + u < Q) {
        const long long r = static_cast<long long>(idx_b[qb + u]) - n0;
        if (r >= 0 && r < kRows && n0 + r < N) rows[u] = static_cast<int>(r);
      }
      mine += rows[u] >= 0;
    }
    int incl = mine;  // inclusive prefix of the hits within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_hits[warp] = incl;
    __syncthreads();
    int p = incl - mine, count = 0;
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      const int h = warp_hits[w];
      if (w < warp) p += h;
      count += h;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (rows[u] >= 0) {
        list_q[p] = static_cast<unsigned short>(tid * kPer + u);
        list_r[p] = static_cast<unsigned char>(rows[u]);
        ++p;
      }
    __syncthreads();
    // the list holds this chunk's queries of the block's rows, ascending.
    // Walk it in pieces: all threads stage the pieces' g rows in shared
    // memory (independent, coalesced loads), then every owner adds its
    // rows' values in list order
    for (int p0 = 0; p0 < count; p0 += kStage) {
      const int m = min(kStage, count - p0);
      {
        // a thread starts all of its loads before its first store
        constexpr int kLoads = kStage * kCols / kBwdThreads;
        float v[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int k = tid + i * kBwdThreads;
          const int e = k / ncol, cc = k - e * ncol;
          v[i] = k < m * ncol
                     ? g_b[static_cast<size_t>(q0 + list_q[p0 + e]) * C + cc]
                     : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int k = tid + i * kBwdThreads;
          const int e = k / ncol, cc = k - e * ncol;
          if (k < m * ncol) stage[e * kCols + cc] = v[i];
        }
      }
      __syncthreads();
      // lane e of every warp looks at entry e's row (kStage is the warp
      // size); a ballot per group of the warp gives each thread the mask
      // of its group's entries, which it then adds in ascending order
      const int r_e = lane < m ? list_r[p0 + lane] : -1;
      unsigned mask = 0;
      const int per_warp = cw >= 32 ? 1 : 32 / cw;  // groups in this warp
      const int g0 = cw >= 32 ? grp : warp * per_warp;
      for (int gi = 0; gi < per_warp; ++gi) {
        const unsigned hit = __ballot_sync(
            0xffffffffu, r_e >= 0 && (r_e & (groups - 1)) == g0 + gi);
        if (g0 + gi == grp) mask = hit;
      }
      if (!col_ok) mask = 0;
      while (mask) {
        const int e = __ffs(mask) - 1;
        mask &= mask - 1;
        acc[list_r[p0 + e] * kCols + c] += stage[e * kCols + c];
      }
      __syncthreads();  // the next piece or chunk overwrites stage and list
    }
  }

  for (int k = tid; k < kRows * kCols; k += kBwdThreads) {
    const int r = k / kCols, cc = k - r * kCols;
    if (n0 + r < N && cc < ncol)
      dtab[(b * N + n0 + r) * C + c0 + cc] = acc[k];
  }
}

template <typename I>
int launch_fwd(const float* table, const I* idx, float* out, int B, int N,
               int C, int Q, cudaStream_t stream) {
  const bool vec = C % 4 == 0 &&
                   (reinterpret_cast<size_t>(table) % 16 == 0) &&
                   (reinterpret_cast<size_t>(out) % 16 == 0);
  const unsigned Cv = vec ? C / 4 : C;
  const unsigned QCv = static_cast<unsigned>(Q) * Cv;
  const dim3 grid((QCv + kFwdThreads - 1) / kFwdThreads, B);
  if (vec)
    gather_fwd_kernel<I, float4><<<grid, kFwdThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), N, Q, Cv);
  else
    gather_fwd_kernel<I, float><<<grid, kFwdThreads, 0, stream>>>(
        table, idx, out, N, Q, Cv);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_bwd(const float* g, const I* idx, float* dtab, int B, int N, int C,
               int Q, cudaStream_t stream) {
  int cw = 1;
  while (cw < C && cw < kCols) cw *= 2;
  const dim3 grid((N + kRows - 1) / kRows, (C + kCols - 1) / kCols, B);
  gather_bwd_kernel<I><<<grid, kBwdThreads, 0, stream>>>(g, idx, dtab, N, C,
                                                        Q, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (B, N, C) float, idx (B, Q) int32 (idx64 == 0) or int64, out
// (B, Q, C). All contiguous on the device; B <= 65535 and Q * C < 2^31
// (checked by the caller). Returns cudaGetLastError() after the launch.
extern "C" int arrl_gather_fwd(const float* table, const void* idx, int idx64,
                               float* out, int B, int N, int C, int Q,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_fwd(table, static_cast<const long long*>(idx), out, B, N, C,
                      Q, s);
  return launch_fwd(table, static_cast<const int*>(idx), out, B, N, C, Q, s);
}

// g (B, Q, C) float, idx (B, Q), dtab (B, N, C): every element of dtab is
// written, so it need not be zeroed. The same limits as the forward's.
extern "C" int arrl_gather_bwd(const float* g, const void* idx, int idx64,
                               float* dtab, int B, int N, int C, int Q,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_bwd(g, static_cast<const long long*>(idx), dtab, B, N, C, Q,
                      s);
  return launch_bwd(g, static_cast<const int*>(idx), dtab, B, N, C, Q, s);
}
