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
// Forward. Bound: bytes (table and idx read once, out written once); the
// table is small (24 KB a sample at N = 1,024 and C = 6) and stays in L1
// and L2, so what a design fights is latency: a dependent table load after
// each idx load. Two kernels, by what the row allows:
// - gather_fwd_vec_kernel, where C is a multiple of 4 and table and out are
//   16-byte aligned: one thread per float4 of the output, grid y over the
//   batch; threads of a warp read neighbouring float4s of a row and write
//   neighbouring float4s.
// - gather_fwd_rows_kernel, at any C and alignment (the narrow rows of this
//   system, C = 3 and 6): a warp owns a run of 32 consecutive queries of the
//   flattened (B x Q) output, whose 32 x C floats are contiguous. Each lane
//   loads its query's idx once and leaves the row's offset in the table (-1
//   out of range) in shared memory; then lane l takes the run's floats l,
//   l + 32, ..: it reads its float's query offset there, loads 4 floats from
//   the table before it stores them, and each store of the warp is 128
//   contiguous bytes. No division by C: the caller passes C's reciprocal in
//   fixed point for a lane's first float and the step of 32 floats as
//   (queries, columns). Loads of neighbouring lanes fall in the same or the
//   next row, so a warp's load touches few sectors. (Scratch variants on the
//   H100: a float4 a lane, staging the run through shared memory for 16-byte
//   stores, 2 or 8 floats ahead, or a grid-stride loop over runs were no
//   faster; PERF.md.)
//
// Backward: deterministic, no atomics on floats, two launches give equal
// bits. Bound: bytes (g and idx read once, d_table written once); at the
// shapes this system has (a few thousand rows, C of 3 to 6) that bound lies
// under the time of one launch, so what the design fights is latency: every
// (row, column) sum is a serial chain in ascending q, the order of a
// sequential index_add_. The queries are therefore sorted by row once per
// sample, and then all rows are summed at once, each by its own lanes with
// several g rows in flight. Three kernels per backward:
//
// 1. gather_bwd_hist_kernel: grid (G, B). Block j of a sample counts the
//    rows of its contiguous chunk of the queries with integer atomics in
//    shared memory (integers commute: deterministic) and writes the N + 1
//    counts to scratch; row N is the dump row of every idx outside [0, N).
// 2. gather_bwd_place_kernel: grid (G, B), a stable counting sort. A block
//    sums the blocks' counts into the row starts (an exclusive scan over
//    the rows; block 0 writes start[b, 0..N]) and into its own base per
//    row (the rows' counts in the earlier blocks). Each of its W warps owns
//    a contiguous sub-range of the chunk and a private counter per row in
//    shared memory: a first walk counts (integer atomics again), a scan per
//    row over the warps turns the counters into offsets, and a second walk
//    places query q at offset + (lanes of its step before it with the same
//    row). A step's lanes draw their places with an atomic add on the
//    offset; only if a lane drew another place than the offset it read, so
//    that some row occurs twice in the step, the lanes that hold a row find
//    each other with a ballot per bit of the row and take their places in
//    lane order. perm[b] then holds the queries grouped by row, ascending q
//    inside each row, the dump row's as the tail.
// 3. gather_bwd_sum_kernel: one group of gw lanes per table row (gw the
//    power of two >= the row's width in floats or float4s, at most 32;
//    wider rows take grid y), grid over all B x N rows, no barrier. A lane
//    walks perm[start[n] : start[n + 1]] and adds into a register from 0
//    in that order. The addresses come from perm, not from the sum, so
//    kAhead loads of g are in flight ahead of the adds and the next kAhead
//    perm entries are fetched beside them. Rows with no query write zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdAhead = 4;  // floats a lane of the rows kernel loads before it stores
constexpr int kHistThreads = 256;
constexpr int kSumThreads = 128;
constexpr int kAhead = 16;  // g rows a lane of the sum keeps in flight
constexpr int kSteps = 4;  // steps of 32 queries whose idx a warp of the sort loads at once
constexpr int kMaxRowBits = 16;  // a row below 2^16: 227 KB hold 3 counters for under 2^15 rows
constexpr int kMaxShared = 227 * 1024;  // dynamic shared memory of a block

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One thread per float4; Cv = C / 4.
template <typename I>
__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_vec_kernel(const float4* __restrict__ table, const I* __restrict__ idx,
                      float4* __restrict__ out, int N, unsigned Q, unsigned Cv) {
  const unsigned QCv = Q * Cv;
  const unsigned e = blockIdx.x * kFwdThreads + threadIdx.x;
  if (e >= QCv) return;
  const size_t b = blockIdx.y;
  const unsigned q = e / Cv;
  const unsigned c = e - q * Cv;
  const long long n = static_cast<long long>(idx[b * Q + q]);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n >= 0 && n < N) v = table[(b * N + n) * Cv + c];
  out[b * QCv + e] = v;
}

// A warp a run of 32 queries of the flattened (B x Q) output; see the notes
// at the top. total = B * Q queries. (m, dq, dc) from the caller:
// 65536 / C + 1 (0 where C > 128), and 32 floats as (dq queries, dc
// columns), so that no lane divides by C.
template <typename I>
__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_rows_kernel(const float* __restrict__ table, const I* __restrict__ idx,
                       float* __restrict__ out, int N, unsigned Q, unsigned C,
                       long long total, unsigned m, unsigned dq, unsigned dc) {
  __shared__ long long rows[kFwdThreads];  // a query's first float in the table, -1 for none
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kFwdThreads + threadIdx.x;
  const long long f0 = f - lane;
  if (f0 >= total) return;  // the whole warp
  long long ro = -1;
  if (f < total) {
    const long long n = static_cast<long long>(idx[f]);
    const long long b = total <= 0xffffffffLL
                            ? static_cast<long long>(static_cast<unsigned>(f) / Q) : f / Q;
    if (n >= 0 && n < N) ro = (b * N + n) * C;
  }
  rows[threadIdx.x] = ro;
  __syncwarp();
  const long long* run_rows = rows + (threadIdx.x - lane);
  const unsigned nq = static_cast<unsigned>(min(32LL, total - f0));  // queries of the run
  const long long nf = static_cast<long long>(nq) * C;  // floats of the run
  float* run = out + f0 * C;
  // (query, column) of the lane's float e = lane, e + 32, ..; a step of 32
  // floats is (dq queries, dc columns)
  unsigned q = m ? (static_cast<unsigned>(lane) * m) >> 16 : 0u;
  unsigned c = lane - q * C;
  for (long long e0 = 0; e0 < nf; e0 += 32 * kFwdAhead) {
    float v[kFwdAhead];
#pragma unroll
    for (int u = 0; u < kFwdAhead; ++u) {
      float x = 0.f;
      if (q < nq) {  // e < nf
        const long long r = run_rows[q];
        if (r >= 0) x = table[r + c];
      }
      v[u] = x;
      q += dq;
      c += dc;
      if (c >= C) {
        c -= C;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdAhead; ++u) {
      const long long e = e0 + 32 * u + lane;
      if (e < nf) run[e] = v[u];
    }
  }
}

// The row a query adds to; N, the dump row, for an idx outside [0, N).
template <typename I>
__device__ __forceinline__ int row_of(I v, int N) {
  const long long n = static_cast<long long>(v);
  return n >= 0 && n < N ? static_cast<int>(n) : N;
}

// The rows of the queries q, q + 32, ... of kSteps steps of a warp's walk;
// N + 1, no row, past the end of the walk.
template <typename I>
__device__ __forceinline__ void load_rows(int (&r)[kSteps], const I* __restrict__ idx_b,
                                          int q, int end, int N) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
    r[u] = q + 32 * u < end ? row_of(idx_b[q + 32 * u], N) : N + 1;
}

// The lanes of the warp that hold the same row r, a value below
// 1 << kMaxRowBits: a ballot per bit of r, the ballots independent of each
// other (a bit that no row has set leaves the mask as it is).
__device__ __forceinline__ unsigned same_row_lanes(int r) {
  unsigned same = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < kMaxRowBits; ++k) {
    const bool bit = (r >> k) & 1;
    const unsigned with_bit = __ballot_sync(0xffffffffu, bit);
    same &= bit ? with_bit : ~with_bit;
  }
  return same;
}

// counts (B, G, N + 1): the rows' counts in block j's chunk of the queries.
template <typename I>
__global__ void __launch_bounds__(kHistThreads)
gather_bwd_hist_kernel(const I* __restrict__ idx, int* __restrict__ counts,
                       int N, int Q, int chunk) {
  extern __shared__ int shared_ints[];
  int* hist = shared_ints;  // N + 1
  const int NR = N + 1;
  const int j = blockIdx.x, G = gridDim.x;
  const size_t b = blockIdx.y;
  for (int n = threadIdx.x; n < NR; n += kHistThreads) hist[n] = 0;
  __syncthreads();
  const long long q0 = static_cast<long long>(j) * chunk;
  const int q1 = static_cast<int>(min(static_cast<long long>(Q), q0 + chunk));
  const I* idx_b = idx + b * Q;
  for (long long q = q0 + threadIdx.x; q < q1; q += kHistThreads)
    atomicAdd(&hist[row_of(idx_b[q], N)], 1);
  __syncthreads();
  int* out = counts + (b * G + j) * NR;
  for (int n = threadIdx.x; n < NR; n += kHistThreads) out[n] = hist[n];
}

// start (B, N + 1), perm (B, Q): see the notes at the top. The block has
// W = blockDim.x / 32 warps and (W + 2) * (N + 1) ints of shared memory.
template <typename I>
__global__ void __launch_bounds__(1024)
gather_bwd_place_kernel(const I* __restrict__ idx, const int* __restrict__ counts,
                        int* __restrict__ start, int* __restrict__ perm, int N,
                        int Q, int chunk) {
  extern __shared__ int shared_ints[];
  __shared__ int warp_sums[32];
  const int NR = N + 1;
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, G = gridDim.x;
  const size_t b = blockIdx.y;
  int* cnt = shared_ints;   // (W, NR): a warp's count, then offset, per row
  int* pre = cnt + W * NR;  // (NR): the row's queries in the earlier blocks
  int* tot = pre + NR;      // (NR): the row's queries, then the row's start

  for (int k = tid; k < W * NR; k += T) cnt[k] = 0;
  const int* counts_b = counts + b * G * NR;
  for (int n = tid; n < NR; n += T) {
    int p = 0, t = 0;
#pragma unroll 8
    for (int jj = 0; jj < G; ++jj) {
      const int c = counts_b[jj * NR + n];
      p += jj < j ? c : 0;
      t += c;
    }
    pre[n] = p;
    tot[n] = t;
  }
  __syncthreads();

  // exclusive scan of tot over the rows; a thread takes `per` rows in a run
  const int per = (NR + T - 1) / T;
  const int r0 = min(NR, tid * per), r1 = min(NR, r0 + per);
  int local = 0;
  for (int n = r0; n < r1; ++n) local += tot[n];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int offset = incl - local;
  for (int w = 0; w < warp; ++w) offset += warp_sums[w];
  for (int n = r0; n < r1; ++n) {
    const int c = tot[n];
    tot[n] = offset;
    offset += c;
  }
  __syncthreads();
  if (j == 0)
    for (int n = tid; n < NR; n += T) start[b * NR + n] = tot[n];

  // the warp's sub-range of the block's chunk, walked 32 queries a step
  const long long c0 = static_cast<long long>(j) * chunk;
  const int q1 = static_cast<int>(min(static_cast<long long>(Q), c0 + chunk));
  const int q0 = static_cast<int>(min(static_cast<long long>(q1), c0));
  const int wchunk = (chunk + W - 1) / W;
  const long long w0 = static_cast<long long>(q0) + static_cast<long long>(warp) * wchunk;
  const int wq0 = static_cast<int>(min(static_cast<long long>(q1), w0));
  const int wq1 = static_cast<int>(min(static_cast<long long>(q1), w0 + wchunk));
  const I* idx_b = idx + b * Q;
  int* mine = cnt + warp * NR;
  const unsigned below = (1u << lane) - 1u;

  // Both walks take kSteps steps a round and load the round's idx before
  // they touch a counter, so a round waits for global memory once. The
  // first only counts: integer atomics on the warp's own counters.
  for (int qb = wq0; qb < wq1; qb += 32 * kSteps) {
    int r[kSteps];
    load_rows(r, idx_b, qb + lane, wq1, N);
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (r[u] < NR) atomicAdd(&mine[r[u]], 1);
  }
  __syncthreads();
  for (int n = tid; n < NR; n += T) {
    int run = tot[n] + pre[n];
    for (int w = 0; w < W; ++w) {
      const int c = cnt[w * NR + n];
      cnt[w * NR + n] = run;
      run += c;
    }
  }
  __syncthreads();
  int* perm_b = perm + b * Q;
  for (int qb = wq0; qb < wq1; qb += 32 * kSteps) {
    int r[kSteps];
    load_rows(r, idx_b, qb + lane, wq1, N);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const bool valid = r[u] < NR;
      const int before = valid ? mine[r[u]] : 0;
      __syncwarp();  // every lane has read the offset before any lane moves it
      // the lanes of one row draw the places before .. before + m - 1, in
      // no order; most steps hold every row once, and then the draw is the place
      int pos = valid ? atomicAdd(&mine[r[u]], 1) : 0;
      if (__any_sync(0xffffffffu, pos != before))
        pos = before + __popc(same_row_lanes(r[u]) & below);
      if (valid) perm_b[pos] = qb + 32 * u + lane;
      __syncwarp();
    }
  }
}

// One group of gw lanes per table row, a lane per column (of V); grid
// (rows, column tiles, B). V is float or float4; Cv the row width in V.
template <typename V>
__global__ void __launch_bounds__(kSumThreads)
gather_bwd_sum_kernel(const V* __restrict__ g, const int* __restrict__ start,
                      const int* __restrict__ perm, V* __restrict__ dtab, int N,
                      int Q, int Cv, int gw) {
  const int grp = threadIdx.x / gw;
  const int n = blockIdx.x * (kSumThreads / gw) + grp;
  const int col = blockIdx.y * gw + (threadIdx.x - grp * gw);
  const size_t b = blockIdx.z;
  if (n >= N || col >= Cv) return;
  const int lo = start[b * (N + 1) + n], hi = start[b * (N + 1) + n + 1];
  const int* pm = perm + b * Q;
  const V* gb = g + b * Q * Cv + col;
  V acc = zero_of(V());
  int q[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) q[u] = lo + u < hi ? pm[lo + u] : 0;
  for (int s = lo; s < hi; s += kAhead) {
    V v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      v[u] = s + u < hi ? gb[static_cast<size_t>(q[u]) * Cv] : zero_of(V());
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = s + kAhead + u;
      q[u] = p < hi ? pm[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (s + u < hi) acc = add(acc, v[u]);
  }
  dtab[(b * N + n) * Cv + col] = acc;
}

template <typename I>
int launch_fwd(const float* table, const I* idx, float* out, int B, int N,
               int C, int Q, cudaStream_t stream) {
  if (C % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0 &&
      reinterpret_cast<size_t>(out) % 16 == 0) {
    const unsigned Cv = C / 4;
    const unsigned QCv = static_cast<unsigned>(Q) * Cv;
    const dim3 grid((QCv + kFwdThreads - 1) / kFwdThreads, B);
    gather_fwd_vec_kernel<I><<<grid, kFwdThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), N, Q, Cv);
  } else {
    const long long total = static_cast<long long>(B) * Q;
    const unsigned blocks = static_cast<unsigned>((total + kFwdThreads - 1) / kFwdThreads);
    const unsigned m = C <= 128 ? 65536u / C + 1 : 0u;
    const unsigned dq = 32u / C;
    gather_fwd_rows_kernel<I><<<blocks, kFwdThreads, 0, stream>>>(
        table, idx, out, N, Q, C, total, m, dq, 32u - dq * C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
cudaError_t launch_sum(const float* g, const int* start, const int* perm,
                       float* dtab, int B, int N, int Q, int Cv,
                       cudaStream_t stream) {
  int gw = 1;
  while (gw < Cv && gw < 32) gw *= 2;
  const int rows = kSumThreads / gw;
  const dim3 grid((N + rows - 1) / rows, (Cv + gw - 1) / gw, B);
  gather_bwd_sum_kernel<V><<<grid, kSumThreads, 0, stream>>>(
      reinterpret_cast<const V*>(g), start, perm, reinterpret_cast<V*>(dtab), N,
      Q, Cv, gw);
  return cudaGetLastError();
}

template <typename I>
int launch_sort(const I* idx, int* counts, int* start, int* perm, int B, int N,
                int Q, int G, int W, cudaStream_t stream) {
  const size_t hist_bytes = sizeof(int) * (static_cast<size_t>(N) + 1);
  const size_t place_bytes = hist_bytes * (static_cast<size_t>(W) + 2);
  if (G < 1 || W < 1 || W > 32 || place_bytes > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaSuccess;
  if (hist_bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(gather_bwd_hist_kernel<I>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(hist_bytes));
  if (rc == cudaSuccess && place_bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(gather_bwd_place_kernel<I>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(place_bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int chunk = (Q + G - 1) / G;
  const dim3 grid(G, B);
  gather_bwd_hist_kernel<I><<<grid, kHistThreads, hist_bytes, stream>>>(
      idx, counts, N, Q, chunk);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  gather_bwd_place_kernel<I><<<grid, 32 * W, place_bytes, stream>>>(
      idx, counts, start, perm, N, Q, chunk);
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

// The backward's sort: idx (B, Q) -> start (B, N + 1) and perm (B, Q), with
// counts (B, G, N + 1) as scratch, all int32 from the caller. G blocks a
// sample and W warps a block sort the queries; (W + 2) * (N + 1) ints must
// fit a block's shared memory. Launches two kernels; returns the first error.
extern "C" int arrl_gather_sort(const void* idx, int idx64, int* counts,
                                int* start, int* perm, int B, int N, int Q,
                                int G, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_sort(static_cast<const long long*>(idx), counts, start, perm,
                       B, N, Q, G, W, s);
  return launch_sort(static_cast<const int*>(idx), counts, start, perm, B, N, Q,
                     G, W, s);
}

// The backward's sum: g (B, Q, C) float and the sort's start and perm ->
// dtab (B, N, C); every element of dtab is written, so it need not be
// zeroed. The same limits as the forward's. One launch.
extern "C" int arrl_gather_segsum(const float* g, const int* start,
                                  const int* perm, float* dtab, int B, int N,
                                  int C, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && (reinterpret_cast<size_t>(g) % 16 == 0) &&
                   (reinterpret_cast<size_t>(dtab) % 16 == 0);
  return static_cast<int>(
      vec ? launch_sum<float4>(g, start, perm, dtab, B, N, Q, C / 4, s)
          : launch_sum<float>(g, start, perm, dtab, B, N, Q, C, s));
}
