// The robust metric after stage 1 on the rigid path, and its gradient with
// respect to (R, t): from stage 1's pts-mode outputs (the counts and the
// gathered slot points of both clouds), the lines and the detached (R, t) of
// each sample, the loss and its validity in three launches for the whole batch
// (arrl_rigid_loss), and dloss/dR (3 x 3) and dloss/dt (3) from the incoming
// gradient in two more (arrl_rigid_loss_grad, the backward).
//
// Replaces no TPU kernel: the JAX package's stage 2 is XLA's
// (a_robust_registration_loss_tpu/ops/metric.py). The port ran it as ATen glue
// (ops/metric.py: rigid_slots after stage 1, then stage2, and their autograd
// backward): about 415 kernels of the classical step's 908, each on (L, kmax)
// or (L, kmax, kmax) tensors, about 0.9 ms of device time of a 1.93 ms step
// at L = 20,000 (PERF.md). The work itself is small: 5.8 MB of slot points,
// 0.48 MB of lines and 0.16 MB of counts read (about 1.9 us at 3.35 TB/s) and
// some 2,000 fp32 operations a line. So it is bound by launches, and the
// design is the fewest passes that keep the exact median and autograd's bits:
//   1. rl_lines:  a block of 128 lines copies their slot points into shared
//                 memory (coalesced), then a thread a line forms both
//                 reconstructions, cloud 1's un-transform (v - t) R^T and
//                 re-transform raw R + t, the masks and the kmax x kmax
//                 squared distances D, and writes each D as a sort key (its
//                 float bits; a masked pair gets a key above every float's).
//                 Each block also leaves its partial counts: the first
//                 digit (the exponent) of its keys and its lines' (k, j)
//                 combos, so that the next pass reads them and not the keys.
//   2. rl_median: a cluster of 8 blocks a sample (distributed shared memory):
//                 the combos' line counts, and a radix select of the lower
//                 median over the keys' bits 30..23 (from the partial
//                 counts), 22..15, 14..7 and 6..0, each digit's histogram
//                 built in each block's shared memory, added over the
//                 cluster in rank order, and searched by every warp; the
//                 keys stay in shared memory between digits. Exact: the
//                 median is the (n-1)//2-th of the n unmasked values,
//                 ranked as torch.sort ranks them with the masked pairs at
//                 +inf (counted into inf's bins, not histogrammed).
//   3. rl_terms:  a thread a line forms everything again from the inputs
//                 (bit for bit the first pass's), then the row and column
//                 minima, Welsch at the median and the per-line term; the
//                 block that finishes last (a ticket) sums the sample's terms
//                 in ATen's order.
// The backward:
//   4. rl_grad:   a thread a line, autograd's backward of that ATen graph
//                 written out, from the incoming gradient: per slot the
//                 factor g_f of dR and dt, written beside raw.
//   5. rl_sum:    a cluster of 8 blocks for each of the 12 entries of
//                 (dR, dt) and each sample: the sum of g_f raw (or g_f) over
//                 the L kmax values in the order ATen's reduction takes for
//                 the tensor autograd reduces there; the blocks play ATen's
//                 512 threads, the first block its trees.
// So the loss is the ATen path's, and dR and dt autograd's, bit for bit: the classical
// loop, the trainers and the benchmark's reference follow the same
// trajectories (a gradient that differs in its last bits takes a 1,000-epoch
// registration or a trainer's epoch elsewhere: measured, PERF.md).
// No float atomics: every sum is taken in a fixed order, so a CUDA graph's
// replay equals the eager call bit for bit. Nothing waits on the host and
// nothing is allocated here: the wrapper (ops/cuda/rigid_loss.py) hands in
// every buffer.
//
// Arithmetic: the ATen path's on the card, operation by operation, every
// operation rounded on its own (-fmad=false, the _rn intrinsics): a division
// by the Python scalar 3 (nnei) is ATen's multiplication by the float
// reciprocal 1/3, 2e-4 is the double rounded to float, clamp_min keeps NaN,
// the minima keep NaN as torch.amin does, exp is CUDA's expf as ATen's (equal
// on every input from 0 down to -104, the range it takes here). The gradient
// follows autograd's formulas: a tie in a row or column minimum shares its
// gradient evenly (amin's backward), masked slots and invalid lines give 0,
// the median is a constant, and a median of exactly 0 makes the loss and the
// gradient NaN while valid stays true. ATen's reductions, as measured on the
// card (torch 2.11): a sum over the K values of j, K <= 128, is pow2_floor(K)
// lanes, lane x holding 0 + v_x + v_(x+P), then a halving tree; a sum over
// n > 128 values is ReduceOrder's split (see rl_sum), the loss's sum over
// lines too. ops/cuda/rigid_loss.py spells the same arithmetic out in
// PyTorch.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // the line passes: a block's threads and lines
constexpr int kNnei = 3;
constexpr int kMaxK = 8;           // kmax 1 to 8
constexpr int kCombos = kMaxK * kMaxK + 1;  // (k, j) combos and the invalid lines' bucket
constexpr int kCluster = 8;        // blocks of a sample's median cluster
constexpr int kMedThreads = 1024;  // threads of a median block
// the median's digits of a key: bits 30..23 (the exponent), 22..15, 14..7
// and 6..0, 256 bins each (the last 128)
constexpr int kDigits = 4, kBins = 256;
__host__ __device__ constexpr int digit_shift(int d) {
  return d == 0 ? 23 : d == 1 ? 15 : d == 2 ? 7 : 0;
}
// the median block's shared ints before its keys: each digit's block
// histogram, the merged histogram, the combos
constexpr int kMedFixed = kDigits * kBins + kBins + 72;
// a line-pass block's partial counts: digit 0 of its keys, its lines' combos
constexpr int kPart = kBins + 72;
// a sample's state, in ints: the lines a combo, the median's key, the loss
// pass's ticket
constexpr int kCombo = 0, kMedian = 80, kTicket = 81, kState = 96;
constexpr int kSumCluster = 8, kSumThreads = 64;  // rl_sum's blocks play ATen's 512 threads
constexpr int kSumTrips = 64;      // trips of a thread staged at once in rl_sum
constexpr int kMaxCtas = 1024;     // ATen blocks over one sum the sum kernels play
constexpr uint32_t kMasked = 0xffffffffu;  // above every float's key
constexpr uint32_t kInfKey = 0x7f800000u;
constexpr uint32_t kNanKey = 0x7fffffffu;  // every NaN ranks last, as torch.sort ranks it
constexpr float kThird = 1.0f / 3.0f;      // ATen divides by the scalar nnei as x * (1/3)
constexpr float kPad = static_cast<float>(2e-4);

static_assert(kState == 96, "ops/cuda/rigid_loss.py:STATE");
static_assert(kPart == 328, "ops/cuda/rigid_loss.py:PART");
static_assert(kSumCluster * kSumThreads == 512, "rl_sum plays 512 threads");

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.amin's minimum: NaN where either is
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp_min(v, 0) on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// A squared distance's sort key: its bits (the value is +0 or more), NaN last
__device__ __forceinline__ uint32_t key_of(float x) {
  return isnan(x) ? kNanKey : __float_as_uint(x);
}

// A sample's keys start on 16 bytes: its L K^2 keys padded to a multiple of 4
__host__ __device__ __forceinline__ int key_stride(int L, int K) { return (L * K * K + 3) & ~3; }

// The planes of the backward's g_f and raw, (3, B L K) each plane padded to
// 16 bytes
__host__ __device__ __forceinline__ size_t grad_plane(int B, int L, int K) {
  return (static_cast<size_t>(B) * L * K + 3) & ~static_cast<size_t>(3);
}

__host__ __device__ constexpr int pow2_floor(int k) {
  return k >= 8 ? 8 : k >= 4 ? 4 : k >= 2 ? 2 : 1;
}

// How ATen's reduction splits a sum over n values (ops/cuda/rigid_loss.py:
// reduce_order): vec, 4-wide loads (n > 128); bw x ny threads, thread (x, y)
// starting at x + bw y; ctas blocks over the same sum.
struct ReduceOrder {
  int vec, bw, ny, ctas;
};

struct Args {
  const float* lines;  // (B, L, 6): direction, then a point on the line
  const int* count;    // (B, 2, L) stage 1's uncapped counts
  const float* pts;    // (B, 2, L, K, 3, 3) stage 1's gathered slot points, 0 on empty slots
  const float* R;      // (B, 3, 3) detached
  const float* t;      // (B, 3) detached
  uint32_t* keys;      // (B, key_stride), a sample's (L, K, K) first
  int* state;          // (B, kState)
  float* terms;        // (B, L) each line's term of the loss
  ReduceOrder loss_order;  // ATen's split of the loss's sum over L terms
  int* hparts;         // (B, blocks of the line passes, kPart)
  float* loss;         // (B,)
  uint8_t* valid;      // (B,)
  float* median;       // (B,)
  int* n_nonempty;     // (B,)
  int L, K, kmin;
};

// The weighted reconstruction sum_i w_i p_i of one slot's neighbours P (3 x 3)
// against a line, ops/metric.py:_recon's order: d_i = sqrt(max(|e|^2 -
// (e.dir)^2 + 2e-4, 0)) with e = p_i - x0, w_i = d_i / ((d_0 + d_1) + d_2).
__device__ __forceinline__ void recon_slot(const float* P, const float* dir, const float* x0,
                                           float out[3]) {
  float d[kNnei];
#pragma unroll
  for (int i = 0; i < kNnei; ++i) {
    const float e0 = sub(P[3 * i], x0[0]), e1 = sub(P[3 * i + 1], x0[1]),
                e2 = sub(P[3 * i + 2], x0[2]);
    const float dac = add(add(mul(e0, e0), mul(e1, e1)), mul(e2, e2));
    const float proj = add(add(mul(e0, dir[0]), mul(e1, dir[1])), mul(e2, dir[2]));
    d[i] = __fsqrt_rn(clamp_min0(add(sub(dac, mul(proj, proj)), kPad)));
  }
  const float dsum = add(add(d[0], d[1]), d[2]);
  float w[kNnei];
#pragma unroll
  for (int i = 0; i < kNnei; ++i) w[i] = div(d[i], dsum);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = add(add(mul(w[0], P[c]), mul(w[1], P[3 + c])), mul(w[2], P[6 + c]));
}

// The line passes' shared memory: a block's lines' slot points, cloud c's
// line i at (c * kThreads + i) * (9 K + 1) floats (a float of padding a line
// keeps the threads' strided reads on different banks).
template <int K>
constexpr int line_smem_bytes() {
  return 2 * kThreads * (9 * K + 1) * static_cast<int>(sizeof(float));
}

// Copy the slot points of lines [l0, l0 + nl) of sample b, both clouds, into
// shared memory; every thread of the block calls it. The loads are coalesced
// and all issued before any is stored: 16 bytes each where a line is whole
// 16-byte words (K a multiple of 4), 4 otherwise.
template <int K>
__device__ void stage_pts(const Args& a, int b, int l0, int nl, float* sp) {
  constexpr int W = 9 * K, S = W + 1;
  constexpr int V = W % 4 == 0 ? 4 : 1;  // floats a load
  constexpr int N = W / V;               // loads a thread, a cloud (a block of kThreads lines)
  const int n = nl * (W / V);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* g = a.pts + ((static_cast<size_t>(b) * 2 + c) * a.L + l0) * W;
    float* d = sp + c * kThreads * S;
    float v[N][V];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = j * kThreads + threadIdx.x;
      if (e < n) {
        if constexpr (V == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(g) + e);
          v[j][0] = f.x;
          v[j][1] = f.y;
          v[j][2] = f.z;
          v[j][3] = f.w;
        } else {
          v[j][0] = __ldg(g + e);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = j * kThreads + threadIdx.x;
      if (e < n) {
        const int line = (e * V) / W, at = (e * V) % W;
#pragma unroll
        for (int i = 0; i < V; ++i) d[line * S + at + i] = v[j][i];
      }
    }
  }
  __syncthreads();
}

// One line's slot points: p1 cloud 1's reconstructions moved back with the
// detached (R, t) and forward again, p2 cloud 2's, both / nnei and 0 on empty
// slots; raw cloud 1's moved back, the gradient's factor.
template <int K>
struct Line {
  float p1[K][3], p2[K][3], raw[K][3];
  int c1, c2, n1, n2;  // counts, and filled slots min(count, K)
  bool ok;             // kmin <= c1, c2 <= K: the line enters the loss
};

// Line l of sample b, its slot points staged at sp (stage_pts)
template <int K>
__device__ __forceinline__ void line_forward(const Args& a, int b, int l, const float* sp,
                                             const float* Rs, const float* ts, Line<K>& o) {
  constexpr int S = 9 * K + 1;
  const float* ln = a.lines + (static_cast<size_t>(b) * a.L + l) * 6;
  const float dir[3] = {ln[0], ln[1], ln[2]}, x0[3] = {ln[3], ln[4], ln[5]};
  const size_t row1 = static_cast<size_t>(b) * 2 * a.L + l, row2 = row1 + a.L;
  o.c1 = a.count[row1];
  o.c2 = a.count[row2];
  o.n1 = min(o.c1, K);
  o.n2 = min(o.c2, K);
  o.ok = o.c1 >= a.kmin && o.c1 <= K && o.c2 >= a.kmin && o.c2 <= K;
  const float* P1 = sp + threadIdx.x * S;
  const float* P2 = sp + (kThreads + threadIdx.x) * S;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float r[3];
    recon_slot(P1 + s * 9, dir, x0, r);
    const bool f1 = s < o.n1;
    float u[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k] = sub(f1 ? r[k] : 0.f, ts[k]);
#pragma unroll
    for (int c = 0; c < 3; ++c)  // (v - t) R^T
      o.raw[s][c] = add(add(mul(u[0], Rs[3 * c]), mul(u[1], Rs[3 * c + 1])),
                        mul(u[2], Rs[3 * c + 2]));
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // raw R + t
      const float f = add(add(add(mul(o.raw[s][0], Rs[c]), mul(o.raw[s][1], Rs[3 + c])),
                              mul(o.raw[s][2], Rs[6 + c])),
                          ts[c]);
      o.p1[s][c] = f1 ? mul(f, kThird) : 0.f;
    }
    recon_slot(P2 + s * 9, dir, x0, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) o.p2[s][c] = s < o.n2 ? mul(r[c], kThird) : 0.f;
  }
}

// D[k][j] = |p1_k - p2_j|^2, summed x, y, z in order
template <int K>
__device__ __forceinline__ void pair_dists(const Line<K>& o, float D[K][K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float e0 = sub(o.p1[k][0], o.p2[j][0]), e1 = sub(o.p1[k][1], o.p2[j][1]),
                  e2 = sub(o.p1[k][2], o.p2[j][2]);
      D[k][j] = add(add(mul(e0, e0), mul(e1, e1)), mul(e2, e2));
    }
  }
}

// Stage 2 of one line as ops/metric.py:stage2 forms it, masked by the line's
// validity: D, the row and column minima over the unmasked entries (+inf
// where none), exp(-(m / median) / 2) of each, the Welsch sums, the
// denominators n_line max(c, 1) and w_line = exp(-|c1 - c2| / 2).
template <int K>
struct Stage2 {
  float D[K][K], rmin[K], cmin[K], er[K], ec[K];
  bool ok1[K], ok2[K];
  float row_sum, col_sum, den1, den2, wl;
};

template <int K>
__device__ __forceinline__ void stage2_line(const Line<K>& o, float med, const int* combo,
                                            int kmin, Stage2<K>& q) {
  const float inf = __int_as_float(0x7f800000);
  pair_dists<K>(o, q.D);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    q.ok1[s] = o.ok && s < o.n1;
    q.ok2[s] = o.ok && s < o.n2;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = q.ok2[0] ? q.D[k][0] : inf;
#pragma unroll
    for (int j = 1; j < K; ++j) v = min_nan(v, q.ok2[j] ? q.D[k][j] : inf);
    q.rmin[k] = v;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float v = q.ok1[0] ? q.D[0][j] : inf;
#pragma unroll
    for (int k = 1; k < K; ++k) v = min_nan(v, q.ok1[k] ? q.D[k][j] : inf);
    q.cmin[j] = v;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    q.er[s] = expf(mul(-div(q.rmin[s], med), 0.5f));
    q.ec[s] = expf(mul(-div(q.cmin[s], med), 0.5f));
    const float rw = q.ok1[s] ? sub(1.f, q.er[s]) : 0.f;
    const float cw = q.ok2[s] ? sub(1.f, q.ec[s]) : 0.f;
    q.row_sum = s == 0 ? rw : add(q.row_sum, rw);
    q.col_sum = s == 0 ? cw : add(q.col_sum, cw);
  }
  const int nc = K - kmin + 1;
  const float n_line = static_cast<float>(o.ok ? combo[(o.c1 - kmin) * nc + (o.c2 - kmin)] : 1);
  q.den1 = mul(n_line, static_cast<float>(max(o.c1, 1)));
  q.den2 = mul(n_line, static_cast<float>(max(o.c2, 1)));
  q.wl = expf(mul(-0.5f, static_cast<float>(abs(o.c1 - o.c2))));
}

__device__ __forceinline__ void load_rt(const Args& a, int b, float* Rs, float* ts) {
#pragma unroll
  for (int i = 0; i < 9; ++i) Rs[i] = a.R[b * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) ts[i] = a.t[b * 3 + i];
}

// The sample's lines a (k, j) combo into shared memory, and the number of
// nonempty combos; every thread of the block calls it.
__device__ __forceinline__ void load_combos(const Args& a, const int* S, int K, int* combo,
                                            int& s_nonempty) {
  const int nc = K - a.kmin + 1;
  for (int i = threadIdx.x; i <= nc * nc; i += blockDim.x) combo[i] = S[kCombo + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < nc * nc; ++i) n += combo[i] > 0;
    s_nonempty = n;
  }
  __syncthreads();
}

// Pass 1. Grid (blocks over L, B). Each block also leaves its partial
// counts: digit 0 of its keys (a histogram a warp, summed) and its lines'
// (k, j) combos.
template <int K>
__global__ void __launch_bounds__(kThreads) rl_lines_kernel(Args a) {
  extern __shared__ float sp[];
  __shared__ int s_h[kThreads / 32][kBins];
  __shared__ int s_c[72];
  const int b = blockIdx.y, t = threadIdx.x, l0 = blockIdx.x * kThreads, l = l0 + t;
  for (int i = t; i < (kThreads / 32) * kBins; i += kThreads) (&s_h[0][0])[i] = 0;
  for (int i = t; i < 72; i += kThreads) s_c[i] = 0;
  stage_pts<K>(a, b, l0, min(kThreads, a.L - l0), sp);
  int cid = -1;
  if (l < a.L) {
    float Rs[9], ts[3];
    load_rt(a, b, Rs, ts);
    Line<K> o;
    line_forward<K>(a, b, l, sp, Rs, ts, o);
    float D[K][K];
    pair_dists<K>(o, D);
    uint32_t key[K * K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        key[k * K + j] = o.ok && k < o.n1 && j < o.n2 ? key_of(D[k][j]) : kMasked;
    }
    uint32_t* out = a.keys + static_cast<size_t>(b) * key_stride(a.L, K) + l * (K * K);
    if constexpr (K * K % 4 == 0) {
#pragma unroll
      for (int i = 0; i < K * K; i += 4)
        reinterpret_cast<uint4*>(out)[i / 4] =
            make_uint4(key[i], key[i + 1], key[i + 2], key[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < K * K; ++i) out[i] = key[i];
    }
    int* mine = s_h[t >> 5];
#pragma unroll
    for (int i = 0; i < K * K; ++i)
      if (key[i] != kMasked) atomicAdd(&mine[key[i] >> digit_shift(0)], 1);
    const int nc = K - a.kmin + 1;
    cid = o.ok ? (o.c1 - a.kmin) * nc + (o.c2 - a.kmin) : nc * nc;
  }
  // a warp adds each combo once: most lines share a few combos
  const unsigned peers = __match_any_sync(0xffffffffu, cid);
  if (cid >= 0 && (t & 31) == __ffs(peers) - 1) atomicAdd(&s_c[cid], __popc(peers));
  __syncthreads();
  int* part = a.hparts + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kPart;
  for (int i = t; i < kBins; i += kThreads) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += s_h[w][i];
    part[i] = v;
  }
  for (int i = t; i < 72; i += kThreads) part[kBins + i] = s_c[i];
}

// The warp's inclusive prefix sum of v over its lanes
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Over the kBins bins of hist (shared memory) plus extra at bin xb: the bin
// d that holds the element of rank k (from 0) in bin order and its rank
// inside that bin. With `median`, k is first set to the lower median's rank
// among the bins' own total, extra to n_keys less that total (the masked
// pairs), and both are returned. Every warp runs it on its own (the same
// answer, and no barrier).
__device__ void select_bin(const int* hist, int xb, bool median, int n_keys, int& k, int& extra,
                           int& d, int& rank) {
  const int lane = threadIdx.x & 31, lo = lane * (kBins / 32);
  int h[kBins / 32], sum = 0;
#pragma unroll
  for (int i = 0; i < kBins / 32; ++i) {
    h[i] = hist[lo + i];
    sum += h[i];
  }
  if (median) {
    const int n = __shfl_sync(0xffffffffu, warp_scan(sum), 31);
    k = n > 0 ? (n - 1) / 2 : 0;
    extra = n_keys - n;
  }
#pragma unroll
  for (int i = 0; i < kBins / 32; ++i) {
    if (lo + i == xb) {
      h[i] += extra;
      sum += extra;
    }
  }
  const int x = warp_scan(sum), before = x - sum;
  const bool here = before <= k && k < x;
  int dd = 0, rr = 0;
  if (here) {
    int c = before;
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) {
      if (k >= c && k < c + h[i]) {
        dd = lo + i;
        rr = k - c;
      }
      c += h[i];
    }
  }
  const unsigned who = __ballot_sync(0xffffffffu, here);
  const int src = who ? __ffs(who) - 1 : 0;
  d = __shfl_sync(0xffffffffu, dd, src);
  rank = __shfl_sync(0xffffffffu, rr, src);
}

// hist (nb bins) summed over the cluster's blocks in rank order, into merged.
// The cluster barrier before it makes every block's histogram whole; each
// digit has a histogram of its own, so none is written while another block
// may read it, and one barrier at the end keeps every block until the last
// reads are done.
__device__ void merge_hist(cg::cluster_group& cluster, int* hist, int* merged, int nb) {
  cluster.sync();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    int v[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v[r] = cluster.map_shared_rank(hist, r)[i];
    int s = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += v[r];
    merged[i] = s;
  }
  __syncthreads();
}

// Pass 2, the median: grid (kCluster, B), a cluster a sample; block rank r
// takes keys [r chunk, (r + 1) chunk) of its sample (chunk a multiple of 4),
// in shared memory when `staged`, and the partial counts of the line blocks
// r, r + kCluster, ...
__global__ void __launch_bounds__(kMedThreads) rl_median_kernel(Args a, int chunk, int staged) {
  extern __shared__ int sm[];
  int* h = sm;  // kDigits x kBins, each written once
  int* merged = h + kDigits * kBins;
  int* combo = merged + kBins;
  uint32_t* kbuf = reinterpret_cast<uint32_t*>(combo + 72);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const int kk = a.K * a.K, n_keys = a.L * kk;
  const int lo = min(rank * chunk, n_keys), hi = min(lo + chunk, n_keys), m = hi - lo;
  const uint32_t* keys = a.keys + static_cast<size_t>(b) * key_stride(a.L, a.K) + lo;
  int* S = a.state + static_cast<size_t>(b) * kState;

  for (int i = t + kBins; i < kDigits * kBins; i += nt) h[i] = 0;
  if (staged) {  // 16-byte loads, 8 a thread in flight; keys past hi read as masked
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
    uint4* b4 = reinterpret_cast<uint4*>(kbuf);
    const int n4 = (m + 3) / 4;
    for (int j0 = 0; j0 < n4; j0 += 8 * kMedThreads) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * kMedThreads + t;
        v[u] = j < n4 ? __ldg(k4 + j) : make_uint4(kMasked, kMasked, kMasked, kMasked);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * kMedThreads + t;
        if (j < n4) {
          uint4 w = v[u];
          if (4 * j + 1 >= m) w.y = kMasked;
          if (4 * j + 2 >= m) w.z = kMasked;
          if (4 * j + 3 >= m) w.w = kMasked;
          b4[j] = w;
        }
      }
    }
  }
  // digit 0 and the combos: this block's share of the line blocks' partials
  const int nblk = (a.L + kThreads - 1) / kThreads;
  const int* hp = a.hparts + static_cast<size_t>(b) * nblk * kPart;
  for (int i = t; i < kPart; i += nt) {
    int s = 0;
#pragma unroll 4
    for (int j = rank; j < nblk; j += kCluster) s += __ldg(hp + static_cast<size_t>(j) * kPart + i);
    if (i < kBins)
      h[i] = s;
    else
      combo[i - kBins] = s;
  }
  cluster.sync();
  const int nc = a.K - a.kmin + 1;
  if (rank == 0) {  // the combos, over the cluster in rank order
    for (int i = t; i <= nc * nc; i += nt) {
      int s = 0;
      for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(combo, r)[i];
      S[kCombo + i] = s;
    }
    if (t == 0) S[kTicket] = 0;
  }
  // the digits in turn: the histogram of the keys that share the digits so
  // far, over the cluster, then the bin of the median's rank in it
  uint32_t prefix = 0;
  int k = 0, masked = 0;
  for (int digit = 0; digit < kDigits; ++digit) {
    int* hd = h + digit * kBins;
    const int sh = digit_shift(digit);
    if (digit > 0) {
      const int top = digit_shift(digit - 1);
      const uint32_t width = (1u << (top - sh)) - 1;
      for (int i0 = 0; i0 < m; i0 += 4 * nt) {  // 4 keys a thread in flight
        uint32_t k4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * nt + t;
          k4[u] = i < m ? (staged ? kbuf[i] : keys[i]) : kMasked;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)  // a masked key's high bits match no prefix
          if ((k4[u] >> top) == prefix) atomicAdd(&hd[(k4[u] >> sh) & width], 1);
      }
    }
    merge_hist(cluster, hd, merged, kBins);
    // the masked pairs sit in +inf's bins while the prefix is +inf's
    const bool inf_prefix = digit == 0 || prefix == (kInfKey >> digit_shift(digit - 1));
    int extra = inf_prefix ? masked : 0, d, rank_in;
    select_bin(merged, static_cast<int>((kInfKey >> sh) & (kBins - 1)), digit == 0, n_keys, k,
               extra, d, rank_in);
    if (digit == 0) masked = extra;
    prefix = prefix << (digit == 0 ? 8 : digit_shift(digit - 1) - sh) | static_cast<uint32_t>(d);
    k = rank_in;
  }
  if (rank == 0 && t == 0) S[kMedian] = static_cast<int>(prefix);
  cluster.sync();  // every block's histograms stay until the last remote read
}

// Whether this block is the last of its sample's blocks to reach this point
// of the pass. Every thread's writes before it are visible to that block.
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// One term of a sum: g_f raw as autograd multiplies them, or g_f; kL2 reads
// through L2 only (values that other blocks of the same kernel wrote)
template <bool kL2 = false>
__device__ __forceinline__ float term_of(const float* g, const float* w, int i) {
  if (kL2) return w ? mul(__ldcg(g + i), __ldcg(w + i)) : __ldcg(g + i);
  return w ? mul(g[i], w[i]) : g[i];
}

// What ATen's thread (x, y) of CTA cta holds after its loop over the n terms
// (Reduce.cuh: input_vectorized_thread_reduce_impl with 4-wide loads, the
// row's first 4 - shift terms taken apart where it starts off 16-byte
// alignment, or thread_reduce_impl with 4 accumulators for n <= 128)
template <bool kL2 = false>
__device__ float thread_value(const float* g, const float* w, int n, int shift, int cta, int x,
                              int y, const ReduceOrder& ro) {
  const int step = ro.bw * ro.ny * ro.ctas;
  int idx = x + ro.bw * y + ro.bw * ro.ny * cta;
  const bool edge = y == 0 && cta == 0;  // the thread that takes the head and the tail
  if (ro.vec) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    int base = 0, end = n;
    if (shift > 0) {
      if (edge && x >= shift && x < 4) v0 = add(v0, term_of<kL2>(g, w, x - shift));
      end = n + shift - 4;
      base = 4 - shift;
    }
    // the trips in batches of 8, their loads issued before the adds
    const int trips = idx * 4 + 3 < end ? (end - 3 - idx * 4 + 4 * step - 1) / (4 * step) : 0;
    for (int j0 = 0; j0 < trips; j0 += 8) {
      float x4[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < trips) {
          const int e = base + (idx + (j0 + u) * step) * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) x4[u][i] = term_of<kL2>(g, w, e + i);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < trips) {
          v0 = add(v0, x4[u][0]);
          v1 = add(v1, x4[u][1]);
          v2 = add(v2, x4[u][2]);
          v3 = add(v3, x4[u][3]);
        }
      }
    }
    const int tail = end - end % 4;
    if (edge && tail + x < end) v0 = add(v0, term_of<kL2>(g, w, base + tail + x));
    return add(add(add(v0, v1), v2), v3);
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (; idx + 3 * step < n; idx += 4 * step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = add(v[i], term_of<kL2>(g, w, idx + i * step));
  }
  for (int i = 0; i < 4 && idx < n; ++i, idx += step) v[i] = add(v[i], term_of<kL2>(g, w, idx));
  return add(add(add(v[0], v[1]), v[2]), v[3]);
}

// ATen's block_x_reduce on the values of its threads laid out (y, x) in A:
// each row's halving tree over x (the shared-memory steps down to 32 lanes,
// then the warp's shuffles, the same tree), leaving row y's sum at A[y bw]
__device__ void x_tree(float* A, int bw, int ny) {
  for (int off = bw / 2; off > 0; off >>= 1) {
    for (int i = threadIdx.x; i < ny * off; i += blockDim.x) {
      const int at = (i / off) * bw + i % off;
      A[at] = add(A[at], A[at + off]);
    }
    __syncthreads();
  }
}

// ATen's block_y_reduce on every lane x < lanes: a halving tree over y
__device__ void y_tree(float* A, int bw, int ny, int lanes) {
  for (int off = ny / 2; off > 0; off >>= 1) {
    for (int i = threadIdx.x; i < off * lanes; i += blockDim.x) {
      const int at = (i / lanes) * bw + i % lanes;
      A[at] = add(A[at], A[at + off * bw]);
    }
    __syncthreads();
  }
}

// ATen's global reduction over the CTAs' results part[0..ctas): its thread u
// adds results u, u + nth, ..., then a y tree on every lane and the x tree of
// row 0. The whole block calls it; the sum is left at A[0].
__device__ void global_tree(const float* part, const ReduceOrder& ro, float* A) {
  const int nth = ro.bw * ro.ny;
  for (int u = threadIdx.x; u < nth; u += blockDim.x) {
    float s = 0.f;
    for (int i = u; i < ro.ctas; i += nth) s = add(s, part[i]);
    A[u] = s;
  }
  __syncthreads();
  y_tree(A, ro.bw, ro.ny, ro.bw);
  x_tree(A, ro.bw, 1);
}

// ATen's sum of the n values g[0..n) (a row that starts `shift` words past
// 16 bytes), split as ro says, by one block of any size that plays ATen's
// threads in turn, reading through L2. The whole block calls it; thread 0
// gets the sum.
__device__ float block_aten_sum(const float* g, int n, int shift, const ReduceOrder& ro,
                                float* A, float* part) {
  const int nth = ro.bw * ro.ny;
  constexpr int kV = 4;  // ATen threads a thread plays at once on the fast path
  if (ro.vec && shift == 0 && ro.ctas == 1 && nth <= kV * static_cast<int>(blockDim.x)) {
    // 16-byte loads of all kV ATen threads' trips, 4 trips at a time in flight
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float acc[kV][4];
    int vv[kV], trips[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      vv[u] = threadIdx.x + u * blockDim.x;
      trips[u] = vv[u] < nth && vv[u] * 4 + 3 < n
                     ? (n - 3 - vv[u] * 4 + 4 * nth - 1) / (4 * nth)
                     : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
    }
    for (int j0 = 0; j0 < trips[0]; j0 += 4) {
      float4 x[4][kV];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < kV; ++u)
          if (j0 + jj < trips[u]) x[jj][u] = __ldcg(g4 + vv[u] + (j0 + jj) * nth);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          if (j0 + jj < trips[u]) {
            acc[u][0] = add(acc[u][0], x[jj][u].x);
            acc[u][1] = add(acc[u][1], x[jj][u].y);
            acc[u][2] = add(acc[u][2], x[jj][u].z);
            acc[u][3] = add(acc[u][3], x[jj][u].w);
          }
        }
      }
    }
    const int tail = n - n % 4;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      if (vv[u] < ro.bw && tail + vv[u] < n) acc[u][0] = add(acc[u][0], __ldcg(g + tail + vv[u]));
      if (vv[u] < nth) A[vv[u]] = add(add(add(acc[u][0], acc[u][1]), acc[u][2]), acc[u][3]);
    }
    __syncthreads();
    x_tree(A, ro.bw, ro.ny);
    y_tree(A, ro.bw, ro.ny, 1);
    return A[0];
  }
  for (int cta = 0; cta < ro.ctas; ++cta) {
    for (int v = threadIdx.x; v < nth; v += blockDim.x)
      A[v] = thread_value<true>(g, nullptr, n, shift, cta, v % ro.bw, v / ro.bw, ro);
    __syncthreads();
    x_tree(A, ro.bw, ro.ny);
    y_tree(A, ro.bw, ro.ny, 1);
    if (threadIdx.x == 0) part[cta] = A[0];
    __syncthreads();
  }
  if (ro.ctas == 1) return part[0];
  global_tree(part, ro, A);
  return A[0];
}

// Pass 3: each line's term of the loss, written to terms; the block that
// finishes last sums the sample's terms in ATen's order (the loss is the ATen
// path's bit for bit). Grid (blocks over L, B).
template <int K>
__global__ void __launch_bounds__(kThreads) rl_terms_kernel(Args a) {
  extern __shared__ float sp[];
  __shared__ int combo[kCombos];
  __shared__ int s_nonempty;
  __shared__ float s_all[512];
  __shared__ float s_part[kMaxCtas];
  const int b = blockIdx.y, t = threadIdx.x, l0 = blockIdx.x * kThreads, l = l0 + t;
  int* S = a.state + static_cast<size_t>(b) * kState;
  load_combos(a, S, K, combo, s_nonempty);
  stage_pts<K>(a, b, l0, min(kThreads, a.L - l0), sp);
  const int nonempty = s_nonempty;
  const float med = __uint_as_float(static_cast<uint32_t>(S[kMedian]));
  float* terms = a.terms + static_cast<size_t>(b) * a.L;
  if (l < a.L) {
    float Rs[9], ts[3];
    load_rt(a, b, Rs, ts);
    Line<K> o;
    line_forward<K>(a, b, l, sp, Rs, ts, o);
    float term = 0.f;
    if (o.ok) {
      Stage2<K> q;
      stage2_line<K>(o, med, combo, a.kmin, q);
      term = mul(q.wl, add(div(q.row_sum, q.den1), div(q.col_sum, q.den2)));
    }
    terms[l] = term;
  }
  if (!last_block(&S[kTicket])) return;
  const int shift = static_cast<int>((static_cast<size_t>(b) * a.L) % 4);
  const float total = block_aten_sum(terms, a.L, shift, a.loss_order, s_all, s_part);
  if (t == 0) {
    a.loss[b] = div(total, static_cast<float>(max(nonempty, 1)));
    a.valid[b] = nonempty > 0;
    a.median[b] = med;
    a.n_nonempty[b] = nonempty;
  }
}

// The backward, pass 1 of 2: a thread a line, autograd's backward of the ATen
// graph written out for every line (an invalid one gives zeros, as there):
// the slot points' gradient g_p1, its j-sum in ATen's order for a reduction
// of kmax values, then g_f = where(filled, g_p1 / nnei, 0), the factor of dR
// and dt, written with raw for the second pass.
template <int K>
__global__ void __launch_bounds__(kThreads) rl_grad_kernel(Args a, const float* cot,
                                                           int cot_stride, float* gf,
                                                           float* raw) {
  extern __shared__ float sp[];
  __shared__ int combo[kCombos];
  __shared__ int s_nonempty;
  const int b = blockIdx.y, t = threadIdx.x, l0 = blockIdx.x * kThreads, l = l0 + t;
  const int* S = a.state + static_cast<size_t>(b) * kState;
  load_combos(a, S, K, combo, s_nonempty);
  stage_pts<K>(a, b, l0, min(kThreads, a.L - l0), sp);
  if (l >= a.L) return;
  const float med = __uint_as_float(static_cast<uint32_t>(S[kMedian]));
  const float nf = static_cast<float>(max(s_nonempty, 1));
  float Rs[9], ts[3];
  load_rt(a, b, Rs, ts);
  Line<K> o;
  line_forward<K>(a, b, l, sp, Rs, ts, o);
  Stage2<K> q;
  stage2_line<K>(o, med, combo, a.kmin, q);
  const float inf = __int_as_float(0x7f800000);
  // dloss / d(per-line term) = cot / n where the line is valid; then through
  // w_line * (row_sum / den1 + col_sum / den2)
  const float gl = mul(o.ok ? div(cot[b * cot_stride], nf) : 0.f, q.wl);
  const float grs = div(gl, q.den1), gcs = div(gl, q.den2);
  // Welsch's backward at each minimum, then amin's: shared by the ties
  float share_r[K], share_c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int cr = 0, cc = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) cr += (q.ok2[j] ? q.D[s][j] : inf) == q.rmin[s];
#pragma unroll
    for (int k = 0; k < K; ++k) cc += (q.ok1[k] ? q.D[k][s] : inf) == q.cmin[s];
    const float gr = div(mul(mul(q.ok1[s] ? grs : 0.f, q.er[s]), 0.5f), med);
    const float gc = div(mul(mul(q.ok2[s] ? gcs : 0.f, q.ec[s]), 0.5f), med);
    share_r[s] = div(gr, static_cast<float>(cr));
    share_c[s] = div(gc, static_cast<float>(cc));
  }
  constexpr int P = pow2_floor(K);  // lanes of ATen's reduction over the K values of j
  const size_t plane = grad_plane(gridDim.y, a.L, K);
  const size_t at = (static_cast<size_t>(b) * a.L + l) * K;
  float g_out[3][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float term[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float g_row = q.ok2[j] ? mul(share_r[k], q.D[k][j] == q.rmin[k] ? 1.f : 0.f) : 0.f;
        const float g_col = q.ok1[k] ? mul(share_c[j], q.D[k][j] == q.cmin[j] ? 1.f : 0.f) : 0.f;
        const float gd = add(g_row, g_col);
        const float e = sub(o.p1[k][c], o.p2[j][c]);
        term[j] = add(mul(gd, e), mul(gd, e));
      }
      // lane x holds 0 + term[x] (+ 0 + term[x + P]), then a halving tree
      float lane[P];
#pragma unroll
      for (int x = 0; x < P; ++x) {
        const float v1 = x + P < K ? add(0.f, term[x + P]) : 0.f;
        lane[x] = add(add(add(add(0.f, term[x]), v1), 0.f), 0.f);
      }
#pragma unroll
      for (int off = P / 2; off > 0; off /= 2) {
#pragma unroll
        for (int x = 0; x < off; ++x) lane[x] = add(lane[x], lane[x + off]);
      }
      g_out[c][k] = k < o.n1 ? mul(lane[0], kThird) : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* gd = gf + c * plane + at;
    float* rd = raw + c * plane + at;
    if constexpr (K % 4 == 0) {
#pragma unroll
      for (int k = 0; k < K; k += 4) {
        reinterpret_cast<float4*>(gd)[k / 4] =
            make_float4(g_out[c][k], g_out[c][k + 1], g_out[c][k + 2], g_out[c][k + 3]);
        reinterpret_cast<float4*>(rd)[k / 4] =
            make_float4(o.raw[k][c], o.raw[k + 1][c], o.raw[k + 2][c], o.raw[k + 3][c]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        gd[k] = g_out[c][k];
        rd[k] = o.raw[k][c];
      }
    }
  }
}

// The backward, pass 2 of 2: a cluster of kSumCluster blocks for entry q of
// (dR, dt) of sample b (dR[r][c] = sum g_f[c] raw[r], q = 3 r + c; dt[c] = sum
// g_f[c], q = 9 + c) over the L K values, in the order ATen's reduction takes
// for the tensor autograd reduces there ((B, L, K) summed over (1, 2),
// keepdim; ReduceOrder). Thread tid of block rank r plays ATen's thread
// v = 64 r + tid = x + bw y of every CTA in turn (its accumulators); block 0
// gathers the 512 values over the cluster and runs the x tree, the y tree
// and, over the CTAs' results, the global reduction's y and x trees. Where a
// sample's row starts on 16 bytes and ATen loads 4 values at once, each
// thread first copies all its 16-byte words into shared memory, every copy in
// flight at once (a trip's loads would otherwise wait on the last's).
__global__ void __launch_bounds__(kSumThreads) rl_sum_kernel(const float* gf, const float* raw,
                                                             int B, int n, ReduceOrder ro,
                                                             float* dR, float* dt) {
  extern __shared__ float4 s_q[];  // [trip][thread]: g_f's words, then raw's
  __shared__ float s_v[kSumThreads];
  __shared__ float s_all[512];
  __shared__ float s_part[kMaxCtas];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / kSumCluster, b = blockIdx.y, tid = threadIdx.x;
  const int c = q < 9 ? q % 3 : q - 9, r = q / 3;
  const size_t plane = grad_plane(B, n, 1);
  const float* g = gf + c * plane + static_cast<size_t>(b) * n;
  const float* w = q < 9 ? raw + r * plane + static_cast<size_t>(b) * n : nullptr;
  const int bw = ro.bw, ny = ro.ny, nth = bw * ny, v = rank * kSumThreads + tid;
  const int shift = static_cast<int>((static_cast<size_t>(b) * n) % 4);
  const bool fast = ro.vec && shift == 0 && ro.ctas == 1;
  for (int cta = 0; cta < ro.ctas; ++cta) {
    float val = 0.f;
    if (fast) {
      const int step = nth, end = n;
      const int trips =
          v < nth && v * 4 + 3 < end ? (end - 3 - v * 4 + 4 * step - 1) / (4 * step) : 0;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const float4* w4 = reinterpret_cast<const float4*>(w);
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      for (int j0 = 0; j0 < trips; j0 += kSumTrips) {
        const int nj = min(kSumTrips, trips - j0);
        for (int j = 0; j < nj; ++j) {
          const int e = v + (j0 + j) * step;
          __pipeline_memcpy_async(&s_q[j * kSumThreads + tid], g4 + e, 16);
          if (w) __pipeline_memcpy_async(&s_q[(kSumTrips + j) * kSumThreads + tid], w4 + e, 16);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        for (int j = 0; j < nj; ++j) {
          const float4 gv = s_q[j * kSumThreads + tid];
          float4 x = gv;
          if (w) {
            const float4 wv = s_q[(kSumTrips + j) * kSumThreads + tid];
            x = make_float4(mul(gv.x, wv.x), mul(gv.y, wv.y), mul(gv.z, wv.z), mul(gv.w, wv.w));
          }
          v0 = add(v0, x.x);
          v1 = add(v1, x.y);
          v2 = add(v2, x.z);
          v3 = add(v3, x.w);
        }
      }
      // the tail, by the first thread of each row's first CTA
      const int tail = end - end % 4;
      if (v < bw && tail + v < end) v0 = add(v0, term_of(g, w, tail + v));
      val = v < nth ? add(add(add(v0, v1), v2), v3) : 0.f;
    } else {
      val = v < nth ? thread_value(g, w, n, shift, cta, v % bw, v / bw, ro) : 0.f;
    }
    s_v[tid] = val;
    cluster.sync();
    if (rank == 0) {
      for (int i = tid; i < nth; i += kSumThreads)
        s_all[i] = cluster.map_shared_rank(s_v, i / kSumThreads)[i % kSumThreads];
      __syncthreads();
      x_tree(s_all, bw, ny);
      y_tree(s_all, bw, ny, 1);
      if (tid == 0) s_part[cta] = s_all[0];
    }
    cluster.sync();  // block 0 has read every block's values
  }
  if (rank != 0) return;
  __syncthreads();
  float out = s_part[0];
  if (ro.ctas > 1) {
    global_tree(s_part, ro, s_all);
    out = s_all[0];
  }
  if (tid == 0) {
    if (q < 9)
      dR[b * 9 + q] = out;
    else
      dt[b * 3 + q - 9] = out;
  }
}

// Launch with a cluster of `cluster` blocks along x
template <typename... KArgs, typename... Actual>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                           int cluster, cudaStream_t s, Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Let kernel take smem bytes of dynamic shared memory beside its static
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int K>
cudaError_t launch_forward(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t line_smem = line_smem_bytes<K>();
  cudaError_t e;
  if ((e = allow_smem(rl_lines_kernel<K>, line_smem)) != cudaSuccess) return e;
  if ((e = allow_smem(rl_terms_kernel<K>, line_smem)) != cudaSuccess) return e;
  rl_lines_kernel<K><<<grid, kThreads, line_smem, s>>>(a);
  // the median: a block's keys stay in shared memory where they fit
  const int n_keys = a.L * K * K, chunk = ((n_keys + kCluster - 1) / kCluster + 3) & ~3;
  const bool staged = (kMedFixed + static_cast<size_t>(chunk)) * sizeof(int) <= 220 * 1024;
  const size_t med_smem = (kMedFixed + (staged ? static_cast<size_t>(chunk) : 0)) * sizeof(int);
  if ((e = allow_smem(rl_median_kernel, med_smem)) != cudaSuccess) return e;
  if ((e = launch_cluster(rl_median_kernel, dim3(kCluster, grid.y, 1), kMedThreads, med_smem,
                          kCluster, s, a, chunk, static_cast<int>(staged))) != cudaSuccess)
    return e;
  rl_terms_kernel<K><<<grid, kThreads, line_smem, s>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_backward(const Args& a, dim3 grid, const float* cot, int cot_stride,
                            float* gf, float* raw, ReduceOrder ro, float* dR, float* dt,
                            cudaStream_t s) {
  constexpr size_t line_smem = line_smem_bytes<K>();
  cudaError_t e;
  if ((e = allow_smem(rl_grad_kernel<K>, line_smem)) != cudaSuccess) return e;
  rl_grad_kernel<K><<<grid, kThreads, line_smem, s>>>(a, cot, cot_stride, gf, raw);
  constexpr size_t sum_smem = 2 * kSumTrips * kSumThreads * sizeof(float4);
  if ((e = allow_smem(rl_sum_kernel, sum_smem)) != cudaSuccess) return e;
  if ((e = launch_cluster(rl_sum_kernel, dim3(12 * kSumCluster, grid.y, 1), kSumThreads,
                          sum_smem, kSumCluster, s, static_cast<const float*>(gf),
                          static_cast<const float*>(raw), static_cast<int>(grid.y), a.L * K, ro,
                          dR, dt)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int K, int kmin) {
  return K < 1 || K > kMaxK || kmin < 1 || kmin > K || L < 1 || B < 1 || B > 65535;
}

bool bad_order(int bw, int ny, int ctas) {
  return bw < 1 || ny < 1 || bw * ny > 512 || ctas < 1 || ctas > kMaxCtas;
}

}  // namespace

// lines (B, L, 6), count (B, 2, L) int32, pts (B, 2, L, K, 3, 3), R (B, 3, 3)
// and t (B, 3), all contiguous on the device; keys (B, L K^2 rounded up to 4) int32,
// terms (B, L) float32 and hparts (B, ceil(L / 128), 328) int32 as scratch;
// (vec, bw, ny, ctas) ATen's split of a sum over L values (ReduceOrder);
// outputs state (B, 96) int32
// (read by the backward), loss, median (B,) float32, valid (B,) bool,
// n_nonempty (B,) int32. 1 <= kmin <= K <= 8, L >= 1, L K^2 < 2^31. Three
// launches on the stream. Returns a CUDA error code, 0 when they were taken.
extern "C" int arrl_rigid_loss(const float* lines, const int* count, const float* pts,
                               const float* R, const float* t, int B, int L, int K, int kmin,
                               int* keys, int* state, float* terms, int* hparts, float* loss,
                               uint8_t* valid, float* median, int* n_nonempty, int vec, int bw,
                               int ny, int ctas, void* stream) {
  if (bad_shape(B, L, K, kmin) || bad_order(bw, ny, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lines, count, pts, R, t, reinterpret_cast<uint32_t*>(keys), state, terms,
               ReduceOrder{vec, bw, ny, ctas}, hparts, loss, valid, median, n_nonempty,
               L, K, kmin};
  using Launch = cudaError_t (*)(const Args&, dim3, cudaStream_t);
  constexpr Launch kLaunch[kMaxK] = {launch_forward<1>, launch_forward<2>, launch_forward<3>,
                                     launch_forward<4>, launch_forward<5>, launch_forward<6>,
                                     launch_forward<7>, launch_forward<8>};
  return static_cast<int>(kLaunch[K - 1](a, dim3((L + kThreads - 1) / kThreads, B, 1),
                                         static_cast<cudaStream_t>(stream)));
}

// The backward of arrl_rigid_loss's call with the same inputs and the state
// it left: cot the incoming gradient of the loss, cot[b * cot_stride]; gf
// and raw (3, B L K rounded up to 4) float32 as scratch; (vec, bw, ny, ctas)
// ATen's split of a sum over L K values (ReduceOrder); outputs dR (B, 3, 3)
// and dt (B, 3). Two launches on the stream.
extern "C" int arrl_rigid_loss_grad(const float* lines, const int* count, const float* pts,
                                    const float* R, const float* t, int B, int L, int K,
                                    int kmin, const int* state, const float* cot,
                                    int cot_stride, float* gf, float* raw, int vec, int bw,
                                    int ny, int ctas, float* dR, float* dt, void* stream) {
  if (bad_shape(B, L, K, kmin) || bad_order(bw, ny, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lines, count, pts, R, t, nullptr, const_cast<int*>(state), nullptr,
               ReduceOrder{}, nullptr, nullptr, nullptr, nullptr, nullptr, L, K, kmin};
  using Launch = cudaError_t (*)(const Args&, dim3, const float*, int, float*, float*,
                                 ReduceOrder, float*, float*, cudaStream_t);
  constexpr Launch kLaunch[kMaxK] = {launch_backward<1>, launch_backward<2>, launch_backward<3>,
                                     launch_backward<4>, launch_backward<5>, launch_backward<6>,
                                     launch_backward<7>, launch_backward<8>};
  return static_cast<int>(kLaunch[K - 1](a, dim3((L + kThreads - 1) / kThreads, B, 1), cot,
                                         cot_stride, gf, raw, ReduceOrder{vec, bw, ny, ctas}, dR,
                                         dt, static_cast<cudaStream_t>(stream)));
}
