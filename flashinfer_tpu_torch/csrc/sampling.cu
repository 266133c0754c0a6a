// Sorting-free sampler family for Hopper (sm_90a): top-k / top-p / min-p
// pivots by fixed 32-step value bisection, then a Gumbel-max draw, a
// renormalisation, or a logit mask.
//
// Replaces the TPU kernel `_family_kernel` (flashinfer_tpu/ops/sampling.py:
// 484, launched by `_family_call` :597). The algorithm is the TPU kernel's,
// step for step, so that the same int32 seed draws the same tokens:
//   * pivots: 32 bisection steps between 0 and the row max (`_BISECT_ITERS`);
//     top-k keeps count(x > mid) >= k, top-p keeps sum(x > mid) >= p; k >=
//     vocab and p >= 1 keep everything (pivot -1);
//   * "seq" (the engine's top_k_first order): top-k, renormalise, top-p;
//   * the draw: argmax of log(p) + Gumbel noise, the noise from a murmur3
//     finalizer of (seed, global row, lane) on the seed's 32 bits in uint32
//     arithmetic, ties to the smallest index. The seed is read from device
//     memory when the caller passes a pointer (a CUDA graph replays with the
//     seed in that memory), else taken by value.
//
// Two routes, chosen by `fi_sampling_family` from the vocabulary size:
//
// The cluster route (`family_cluster_kernel`). The TPU kernel keeps its
// row tile in VMEM and runs every bisection on on-chip data. No SM holds a
// 513 KB row (128256 f32), but a cluster of C = 8 CTAs (the portable size)
// of 512 threads does: each CTA loads its contiguous slice of ceil(V / C)
// entries (64 KB at V = 128256) once, with 16-byte loads, into shared
// memory, folding the row max and min into that load. The CTAs arrive on
// the cluster barrier before the load and wait on it after, so every CTA
// of the cluster runs before any writes another's shared memory. A
// cluster pass then evaluates a whole S = 4-level subtree of the
// bisection: the 2^S - 1 midpoints the sequential loop could visit in its
// next S steps, each `(lo + hi) * 0.5f` from its own path's lo and hi, are
// counted (or their masses summed) in one sweep of the slices, and the S
// decisions are walked, so the pivots are the 32-step loop's by
// construction. Entries at or below the subtree's smallest midpoint count
// for none of them and are skipped. A CTA reduces its partials (warp
// shuffles, one shared-memory step) and pushes them into every CTA's slot
// for its rank (two slots, alternating, so one barrier a pass suffices);
// after `barrier.cluster` each CTA combines the C slots in rank order from
// its own shared memory, so every CTA takes the same decision.
//   Once a top-k (count) search's lo has at most kGather (1024) entries
// above it (every later midpoint lies above lo, so no other entry counts
// again), each CTA writes its entries above lo, with their indices, into
// every CTA's list, placed by the per-CTA counts of the pass that set lo,
// and one barrier completes the lists. Warp 0 of each CTA then finishes
// alone: the rest of the search, five steps a pass (lane j tests node j + 1
// against the whole list, a ballot gives the decisions), then for "seq"
// the top-k set's sum, stage 1 and the top-p search on the list, and the
// draw (rank 0) or renorm's total. Rows that
// never get there (flat rows, k near V, top-p alone) stay on cluster
// passes. The cluster ends on a barrier, so no CTA's shared memory goes
// while another writes or reads.
//   Cluster reductions for "seq" + sample with P = ceil(32 / S) a pivot:
// the load, the top-k passes until the gather (2 at S = 4 on peaked rows)
// and the gather: 4, then 56 single-warp steps; without the gather 1 + P +
// 1 + P + 1 (19 at S = 4); each then the exit barrier; against 68 L2
// passes in the streaming route. What bounds it: latency, not bytes: the
// barriers and the CTA reductions around them, the warp's steps, one HBM
// read of the row and the launch. Measured slower on the H100 (PERF.md): S
// = 3 or 5, and clusters of 16, of which the card runs 7 at once, so that
// 8 rows take two waves.
//
// The streaming route (`family_stream_kernel`), for rows whose slices
// exceed a CTA's shared memory (beyond 409,600 entries): one CTA of 1024
// threads per row re-reads the row from L2 on every bisection step, ~68
// passes for "seq".

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kIters = 32;  // _BISECT_ITERS
// a CTA's slice may take this much of its 227 KB of shared memory (the
// gathered list takes 8 KB more)
constexpr int kMaxSliceBytes = 200 * 1024;
constexpr int kCluster = 8;    // a row's CTAs
constexpr int kLevels = 4;     // bisection steps a cluster pass
constexpr int kThreads = 512;  // a cluster CTA's threads
// a count search gathers the entries above its lo into one list, and
// finishes in each CTA alone, once they are this few
constexpr int kGather = 1024;

enum Filt { kNone = 0, kTopK = 1, kTopP = 2, kMinP = 3, kJoint = 4, kSeq = 5 };
enum Out { kSample = 0, kRenorm = 1, kMaskLogits = 2 };

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// the Gumbel-perturbed log-probability of kept value v > 0 at global lane j
__device__ __forceinline__ float gumbel_score(float v, uint32_t base, int j) {
  const uint32_t h = mix(mix(base + uint32_t(j) * 40503u));
  const float u = __uint2float_rn(h >> 8) * (1.0f / 16777216.0f) + 1e-7f;
  return logf(v) + -logf(-logf(u));
}

__device__ __forceinline__ uint32_t noise_base(int seed, int row) {
  return uint32_t(seed) + uint32_t(row) * 0x9E3779B9u;
}

// (value, index) argmax, ties to the smaller index
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// The kept (unnormalised) value of an entry after the filter: x is the raw
// probability, or for "seq" its stage-1 value (x > tk ? x : 0) / s1.
struct Keep {
  int filt;
  float tk, tp, minp_t;
  __device__ __forceinline__ float operator()(float x) const {
    switch (filt) {
      case kTopK: return x > tk ? x : 0.f;
      case kTopP: return x > tp ? x : 0.f;
      case kMinP: return x >= minp_t ? x : 0.f;
      case kJoint: return x > fmaxf(tk, tp) ? x : 0.f;
      case kSeq: return x > tp ? x : 0.f;
      default: return x;
    }
  }
};

// =================================================================== cluster

// Reduction operators over the 32-bit words of the slots.
struct AddF {
  using V = float;
  static __device__ float op(float a, float b) { return a + b; }
  static __device__ uint32_t enc(float a) { return __float_as_uint(a); }
  static __device__ float dec(uint32_t u) { return __uint_as_float(u); }
};
struct AddI {
  using V = int;
  static __device__ int op(int a, int b) { return a + b; }
  static __device__ uint32_t enc(int a) { return uint32_t(a); }
  static __device__ int dec(uint32_t u) { return int(u); }
};
struct MaxF {
  using V = float;
  static __device__ float op(float a, float b) { return fmaxf(a, b); }
  static __device__ uint32_t enc(float a) { return __float_as_uint(a); }
  static __device__ float dec(uint32_t u) { return __uint_as_float(u); }
};

template <int C, int T>
struct ClusterRed {
  uint32_t part[T / 32][32];  // each warp's partials
  uint32_t slot[2][C][32];    // every CTA's partials, by rank, pushed there
  float share[5];             // warp 0's results, for its CTA
};

// A CTA's reduction state: the slot parity, and the cluster reductions and
// warp-0 bisection steps so far (reported when the caller asks).
template <int C, int T>
struct Ctx {
  ClusterRed<C, T>& red;
  int phase, cluster_passes, local_steps;
};

// Reduces K partials of every thread over the cluster: lane j of every warp
// of every CTA gets total j (warps combined in order, then CTAs in rank
// order). Each CTA pushes its partials into every CTA's slot for its rank
// before the barrier, so the combining reads local shared memory. The
// slots alternate between passes: a CTA writes a slot again only after
// every CTA has passed the next barrier, so has read it. `idle`: this
// thread's partials are the identity 0 (a sum over no entry), so a warp of
// idle threads skips its shuffles. Returns the slot parity used.
template <int C, int T, typename Op, int K>
__device__ __forceinline__ int cluster_totals(typename Op::V (&v)[K],
                                              typename Op::V& total,
                                              Ctx<C, T>& cx, bool idle) {
  static_assert(K <= 32, "a pass reduces at most 32 partials");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!__all_sync(0xffffffffu, idle)) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[j] = Op::op(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) cx.red.part[warp][j] = Op::enc(v[j]);
  }
  __syncthreads();
  const int buf = cx.phase & 1;
  ++cx.phase;
  ++cx.cluster_passes;
  cg::cluster_group cl = cg::this_cluster();
  if (warp == 0 && lane < K) {
    typename Op::V a = Op::dec(cx.red.part[0][lane]);
#pragma unroll
    for (int w = 1; w < T / 32; ++w)
      a = Op::op(a, Op::dec(cx.red.part[w][lane]));
    uint32_t* mine = &cx.red.slot[buf][blockIdx.x][lane];
#pragma unroll
    for (int r = 0; r < C; ++r) *cl.map_shared_rank(mine, r) = Op::enc(a);
  }
  cl.sync();  // barrier.cluster.arrive.release + wait.acquire
  const int j = lane < K ? lane : 0;
  total = Op::dec(cx.red.slot[buf][0][j]);
#pragma unroll
  for (int r = 1; r < C; ++r)
    total = Op::op(total, Op::dec(cx.red.slot[buf][r][j]));
  return buf;
}

// cluster_totals with every total handed to every thread, in v.
template <int C, int T, typename Op, int K>
__device__ __forceinline__ void reduce(typename Op::V (&v)[K], Ctx<C, T>& cx,
                                       bool idle = false) {
  typename Op::V total;
  cluster_totals<C, T, Op, K>(v, total, cx, idle);
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __shfl_sync(0xffffffffu, total, j);
}

// The values a search runs on: the entries as they are, or stage 1 of
// "seq" (the top-k set renormalised). `floor(tmin)`: entries at or below it
// map to at most tmin, so they pass no midpoint of a sweep and are skipped.
struct Ident {
  __device__ __forceinline__ float operator()(float x) const { return x; }
  __device__ __forceinline__ float floor(float tmin) const { return tmin; }
};
struct Stage1 {
  float tk, s1, zero;  // zero = 0 / s1
  __device__ __forceinline__ float operator()(float x) const {
    return x > tk ? x / s1 : zero;
  }
  __device__ __forceinline__ float floor(float) const { return tk; }
};

// Bisection steps over the slices xs[0, n4) mapped by f, S a pass, by the
// whole cluster, from step `done` until all 32 are done or until a count
// search's lo has at most `gather_at` entries above it (-1: never). Count
// mode keeps count(f(x) > mid) >= k and tracks c_lo = count(f(x) > lo),
// and in lo_cnt each CTA's share of it; mass mode keeps sum(f(x) > mid ?
// f(x) : 0) >= p. Each pass evaluates the 2^S - 1 midpoints of the next S
// steps (node n spans (nl, nh) and tests t[n - 1]; its children are 2n,
// not ok, and 2n + 1, ok); lane n - 1 gets node n's total, a ballot the
// decisions, and the walk recomputes the chosen midpoints as the
// sequential loop does, so the pivot is that loop's. Returns the steps
// done.
template <int C, int S, int T, bool MASS, typename F>
__device__ int bisect(const float4* xs, int n4, F f, float& lo, float& hi,
                      int done, int k, float p, int& c_lo, int (&lo_cnt)[C],
                      int gather_at, Ctx<C, T>& cx) {
  constexpr int K = (1 << S) - 1;  // the subtree's nodes, heap order
  using Op = typename std::conditional<MASS, AddF, AddI>::type;
  using V = typename Op::V;
  const int lane = threadIdx.x & 31;
  while (done < kIters && c_lo > gather_at) {
    float t[K], nl[K], nh[K];
    nl[0] = lo;
    nh[0] = hi;
    t[0] = (lo + hi) * 0.5f;
#pragma unroll
    for (int n = 2; n <= K; ++n) {
      const int par = n / 2 - 1;
      nl[n - 1] = (n & 1) ? t[par] : nl[par];
      nh[n - 1] = (n & 1) ? nh[par] : t[par];
      t[n - 1] = (nl[n - 1] + nh[n - 1]) * 0.5f;
    }
    float tmin = t[0];
#pragma unroll
    for (int j = 1; j < K; ++j) tmin = fminf(tmin, t[j]);
    const float skip = f.floor(tmin);
    V acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = V(0);
    bool idle = true;
    for (int q = threadIdx.x; q < n4; q += T) {
      const float4 v4 = xs[q];
      if (fmaxf(fmaxf(v4.x, v4.y), fmaxf(v4.z, v4.w)) <= skip) continue;
      idle = false;
      const float e[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e[c] <= skip) continue;
        const float x = f(e[c]);
        if (x <= tmin) continue;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if constexpr (MASS) acc[j] += x > t[j] ? x : 0.f;
          else acc[j] += x > t[j] ? 1 : 0;
        }
      }
    }
    V total;
    const int buf = cluster_totals<C, T, Op, K>(acc, total, cx, idle);
    bool ok;
    if constexpr (MASS) ok = total >= p;
    else ok = total >= k;
    const unsigned oks = __ballot_sync(0xffffffffu, ok && lane < K);
    const int levels = kIters - done < S ? kIters - done : S;
    int last_ok = 0;
    for (int l = 0, nd = 1; l < levels; ++l) {
      const float mid = (lo + hi) * 0.5f;
      if ((oks >> (nd - 1)) & 1) {
        lo = mid;
        last_ok = nd;
        nd = 2 * nd + 1;
      } else {
        hi = mid;
        nd = 2 * nd;
      }
    }
    if constexpr (!MASS) {
      const int c = __shfl_sync(0xffffffffu, int(total),
                                last_ok > 0 ? last_ok - 1 : 0);
      if (last_ok > 0) {
        c_lo = c;
#pragma unroll
        for (int r = 0; r < C; ++r)
          lo_cnt[r] = int(cx.red.slot[buf][r][last_ok - 1]);
      }
    }
    done += levels;
  }
  return done;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The bisection's steps from step `done`, by warp 0 alone on a list of at
// most kGather values lv[0, n) that holds every entry the search counts
// above lo, five steps a pass: lane j tests node j + 1 of the pass's
// subtree, its midpoint computed along its own path from the root as the
// sequential loop would, against the whole list, so every lane holds an
// exact count (or a sum in a fixed order) with no reduction; a ballot
// gives the decisions, and the walk recomputes the chosen midpoints. Count
// mode keeps count(x > mid) >= k, mass mode sum(x > mid ? x : 0) >= p.
// `steps` counts the steps.
template <bool MASS>
__device__ float warp_bisect(const float* lv, int n, float lo, float hi,
                             int done, int k, float p, int& steps) {
  constexpr int S = 5;
  const int lane = threadIdx.x & 31, node = lane + 1;
  const int depth = 31 - __clz(node);  // node 32 (lane 31) is unused
  const float4* lv4 = reinterpret_cast<const float4*>(lv);
  while (done < kIters) {
    float a = lo, b = hi;
#pragma unroll
    for (int d = S - 1; d >= 0; --d) {
      if (d >= depth) continue;
      const float mid = (a + b) * 0.5f;
      if ((node >> d) & 1) a = mid; else b = mid;
    }
    const float t = (a + b) * 0.5f;
    // four sums, one a component of the list's float4s, so loads and adds
    // overlap; a count is exact, a mass the same f32 sum in every CTA
    int c[4] = {0, 0, 0, 0};
    float m[4] = {0.f, 0.f, 0.f, 0.f};
    const auto add = [&](int i, float v) {
      if constexpr (MASS) m[i] += v > t ? v : 0.f;
      else c[i] += int(v > t);
    };
#pragma unroll 4
    for (int q = 0; q < n / 4; ++q) {
      const float4 v = lv4[q];
      add(0, v.x);
      add(1, v.y);
      add(2, v.z);
      add(3, v.w);
    }
    for (int i = n / 4 * 4; i < n; ++i) add(i & 3, lv[i]);
    bool ok;
    if constexpr (MASS) ok = (m[0] + m[1]) + (m[2] + m[3]) >= p;
    else ok = (c[0] + c[1]) + (c[2] + c[3]) >= k;
    const unsigned oks = __ballot_sync(0xffffffffu, ok);
    const int levels = kIters - done < S ? kIters - done : S;
    for (int l = 0, nd = 1; l < levels; ++l) {
      const float mid = (lo + hi) * 0.5f;
      if ((oks >> (nd - 1)) & 1) { lo = mid; nd = 2 * nd + 1; }
      else { hi = mid; nd = 2 * nd; }
    }
    done += levels;
    steps += levels;
  }
  return lo;
}

// The row's entries above lo, with their global indices, written into
// every CTA's list (lv, li) in rank order, each CTA's in its threads'
// order: lo_cnt, each CTA's count above lo, places them, so each CTA
// pushes its own into every list, and one barrier completes the lists.
// Returns their number (at most kGather: the caller knows the count).
template <int C, int T>
__device__ int gather(const float4* sx, int n4, int start, float lo,
                      const int (&lo_cnt)[C], float* lv, int* li,
                      Ctx<C, T>& cx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int m = 0;
  for (int q = threadIdx.x; q < n4; q += T) {
    const float4 v = sx[q];
    m += int(v.x > lo) + int(v.y > lo) + int(v.z > lo) + int(v.w > lo);
  }
  int incl = m;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) cx.red.part[warp][0] = uint32_t(incl);
  __syncthreads();
  int off = incl - m, total = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w)
    off += w < warp ? int(cx.red.part[w][0]) : 0;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    off += r < int(blockIdx.x) ? lo_cnt[r] : 0;
    total += lo_cnt[r];
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int q = threadIdx.x; q < n4 && m > 0; q += T) {
    const float4 v = sx[q];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (e[c] > lo) {
#pragma unroll
        for (int r = 0; r < C; ++r) {
          *cl.map_shared_rank(lv + off, r) = e[c];
          *cl.map_shared_rank(li + off, r) = start + 4 * q + c;
        }
        ++off;
      }
    }
  }
  ++cx.cluster_passes;
  cl.sync();
  return total;
}

// A count pivot over the slices: cluster passes until the entries above lo
// are few enough to gather, then warp 0 of each CTA finishes on the
// gathered list and shares the pivot with its CTA. `n_list`: the list's
// length, -1 if nothing was gathered.
template <int C, int S, int T>
__device__ float count_pivot(const float4* sx, int n4, int start, float lo,
                             float hi, int k, float* lv, int* li,
                             int& n_list, Ctx<C, T>& cx) {
  int c_lo = 0x7fffffff;  // unknown until a pass sets lo
  int lo_cnt[C];
  const int done = bisect<C, S, T, false>(sx, n4, Ident{}, lo, hi, 0, k, 0.f,
                                          c_lo, lo_cnt, kGather, cx);
  n_list = -1;
  if (done < kIters) {
    n_list = gather<C, T>(sx, n4, start, lo, lo_cnt, lv, li, cx);
    if (threadIdx.x < 32) {
      lo = warp_bisect<false>(lv, n_list, lo, hi, done, k, 0.f,
                              cx.local_steps);
      if (threadIdx.x == 0) cx.red.share[4] = lo;
    }
    __syncthreads();
    lo = cx.red.share[4];
  }
  return lo;
}

// Entries 4q..4q+3 of a slice of `real` entries to o: one 16-byte store
// where o is aligned and all four are real.
__device__ __forceinline__ void store4(float* o, bool vec, int q, int real,
                                       const float (&e)[4]) {
  const int i = 4 * q;
  if (vec && i + 3 < real) {
    *reinterpret_cast<float4*>(o + i) = make_float4(e[0], e[1], e[2], e[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (i + c < real) o[i + c] = e[c];
}

// The Gumbel-max draw's (score, index) over entries [0, n) of `entry`,
// ties to the smaller index: over warp 0 (WARP), every lane getting it,
// else over the CTA, thread 0 getting it.
template <int T, bool WARP, typename Red, typename G>
__device__ void draw(int n, G entry, float& best, int& best_i, Red& red) {
  best = -CUDART_INF_F;
  best_i = 0x7fffffff;
  for (int i = WARP ? threadIdx.x & 31 : threadIdx.x; i < n;
       i += WARP ? 32 : T) {
    float s;
    int j;
    entry(i, s, j);
    arg_better(best, best_i, s, j);
  }
  for (int o = 16; o > 0; o >>= 1)
    arg_better(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
               __shfl_xor_sync(0xffffffffu, best_i, o));
  if (WARP) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red.part[warp][0] = __float_as_uint(best);
    red.part[warp][1] = uint32_t(best_i);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < T / 32; ++w)
      arg_better(best, best_i, __uint_as_float(red.part[w][0]),
                 int(red.part[w][1]));
}

// One cluster of C CTAs per row (grid (C, batch), cluster (C, 1, 1)). Each
// CTA's dynamic shared memory holds its slice of `slice` entries (a
// multiple of 4 T), then the gathered list.
template <int C, int S, int T>
__global__ void __launch_bounds__(T, 1)
family_cluster_kernel(const float* __restrict__ xs,
                      const int* __restrict__ ks,
                      const float* __restrict__ ps, int vocab, int slice,
                      int filt, int out_mode,
                      const int* __restrict__ seed_dev, int seed_val,
                      int* __restrict__ out_tok,
                      float* __restrict__ out_row, int* __restrict__ stats) {
  extern __shared__ float4 sx[];
  __shared__ ClusterRed<C, T> red;
  float* lv = reinterpret_cast<float*>(sx + slice / 4);
  int* li = reinterpret_cast<int*>(lv + kGather);
  Ctx<C, T> cx{red, 0, 0, 0};
  cg::cluster_group cl = cg::this_cluster();
  // distributed shared memory may be touched only once every CTA of the
  // cluster runs: arrive now, wait after the load (relaxed: this barrier
  // orders no memory)
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  const int rank = blockIdx.x;  // == the CTA's rank in its cluster
  const int row = blockIdx.y;
  const int start = rank * slice;
  const int real = max(0, min(slice, vocab - start));
  const int n4 = slice / 4;
  const float* x = xs + size_t(row) * vocab + start;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int k = ks[row];
  const float p = ps[row];

  // the load: the slice into shared memory, with the row's max and min;
  // past the row's end -inf for logits, 0 for probabilities (neither
  // passes a pivot, and 0 adds nothing to a sum)
  const float pad = out_mode == kMaskLogits ? -CUDART_INF_F : 0.f;
  float mm[2] = {-CUDART_INF_F, -CUDART_INF_F};  // max, -min
#pragma unroll 4
  for (int q = threadIdx.x; q < n4; q += T) {
    const int i = 4 * q;
    float4 v;
    if (vec && i + 3 < real) {
      v = __ldg(reinterpret_cast<const float4*>(x + i));
      mm[0] = fmaxf(mm[0], fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      mm[1] = fmaxf(mm[1], -fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    } else {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[c] = i + c < real ? x[i + c] : pad;
        if (i + c < real) {
          mm[0] = fmaxf(mm[0], e[c]);
          mm[1] = fmaxf(mm[1], -e[c]);
        }
      }
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    sx[q] = v;
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  reduce<C, T, MaxF, 2>(mm, cx);
  const float rmax = mm[0], rmin = -mm[1];
  float* o = out_row + size_t(row) * vocab + start;
  const bool ovec = (reinterpret_cast<uintptr_t>(o) & 15) == 0;
  int n_list = -1;  // the gathered list's length, -1 if none

  if (out_mode == kMaskLogits) {
    // top-k in the logit domain, bisecting between the row min and max
    float t = count_pivot<C, S, T>(sx, n4, start, rmin, rmax, k, lv, li,
                                   n_list, cx);
    if (k >= vocab) t = t - 1.f;
    for (int q = threadIdx.x; q < n4; q += T) {
      const float4 v = sx[q];
      const float e[4] = {v.x > t ? v.x : -CUDART_INF_F,
                          v.y > t ? v.y : -CUDART_INF_F,
                          v.z > t ? v.z : -CUDART_INF_F,
                          v.w > t ? v.w : -CUDART_INF_F};
      store4(o, ovec, q, real, e);
    }
  } else {
    Keep keep{filt, -1.f, -1.f, 0.f};
    if ((filt == kTopK || filt == kJoint || filt == kSeq) && k < vocab)
      keep.tk = count_pivot<C, S, T>(sx, n4, start, 0.f, rmax, k, lv, li,
                                     n_list, cx);
    Stage1 st{-1.f, 1.f, 0.f};  // for "seq": the top-k set renormalised
    const auto kept = [&](float e) {
      return keep(filt == kSeq ? st(e) : e);
    };
    const uint32_t base =
        noise_base(seed_dev != nullptr ? *seed_dev : seed_val, row);
    float total = 0.f;  // renorm's sum of the kept entries
    if (n_list >= 0 && filt != kJoint) {
      // The list holds every kept entry, and every entry a later search
      // counts ("seq": the top-k set). Warp 0 of each CTA finishes alone:
      // the top-k set's sum, stage 1 in place, the top-p pivot, then
      // renorm's total or (rank 0) the draw.
      if (threadIdx.x < 32 && (out_mode == kRenorm || rank == 0)) {
        if (filt == kSeq) {
          float s1 = 0.f;
          for (int i = threadIdx.x; i < n_list; i += 32)
            s1 += lv[i] > keep.tk ? lv[i] : 0.f;
          s1 = warp_sum(s1);
          st = Stage1{keep.tk, s1, 0.f / s1};
          for (int i = threadIdx.x; i < n_list; i += 32) lv[i] = st(lv[i]);
          __syncwarp();
          if (p < 1.f)  // stage 1's max is the row max's
            keep.tp = warp_bisect<true>(lv, n_list, 0.f, st(rmax), 0, 0, p,
                                        cx.local_steps);
        }
        // the list's values are now what `keep` takes
        if (out_mode == kRenorm) {
          for (int i = threadIdx.x; i < n_list; i += 32) total += keep(lv[i]);
          total = warp_sum(total);
        } else {
          // nothing kept draws index 0, the row's first entry
          float best;
          int best_i;
          draw<T, true>(n_list, [&](int i, float& sc, int& j) {
            const float kv = keep(lv[i]);
            j = li[i];
            sc = kv > 0.f ? gumbel_score(kv, base, j) : -CUDART_INF_F;
          }, best, best_i, red);
          if (threadIdx.x == 0)
            out_tok[row] = best > -CUDART_INF_F ? best_i : 0;
        }
        if (threadIdx.x == 0) {
          red.share[0] = st.s1;
          red.share[1] = st.zero;
          red.share[2] = keep.tp;
          red.share[3] = total;
        }
      }
      if (out_mode == kRenorm) {
        __syncthreads();
        if (filt == kSeq) st = Stage1{keep.tk, red.share[0], red.share[1]};
        keep.tp = red.share[2];
        total = red.share[3];
      }
    } else {
      // the whole cluster: the top-k set's sum over the slices (its max is
      // the row max's), the top-p pivot, renorm's total or the draw
      if (filt == kSeq) {
        const float tk = keep.tk;
        float s1[1] = {0.f};
        bool idle = true;
        for (int q = threadIdx.x; q < n4; q += T) {
          const float4 v = sx[q];
          if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) <= tk) continue;
          idle = false;
          s1[0] += v.x > tk ? v.x : 0.f;
          s1[0] += v.y > tk ? v.y : 0.f;
          s1[0] += v.z > tk ? v.z : 0.f;
          s1[0] += v.w > tk ? v.w : 0.f;
        }
        reduce<C, T, AddF, 1>(s1, cx, idle);
        st = Stage1{tk, s1[0], 0.f / s1[0]};
      }
      if ((filt == kTopP || filt == kJoint || filt == kSeq) && p < 1.f) {
        float lo = 0.f, hi = filt == kSeq ? st(rmax) : rmax;
        int c_lo = 0x7fffffff, lo_cnt[C];
        if (filt == kSeq)
          bisect<C, S, T, true>(sx, n4, st, lo, hi, 0, 0, p, c_lo, lo_cnt,
                                -1, cx);
        else
          bisect<C, S, T, true>(sx, n4, Ident{}, lo, hi, 0, 0, p, c_lo,
                                lo_cnt, -1, cx);
        keep.tp = lo;
      }
      if (filt == kMinP) keep.minp_t = p * rmax;
      if (out_mode == kRenorm) {
        float s[1] = {0.f};
        for (int q = threadIdx.x; q < n4; q += T) {
          const float4 v = sx[q];
          s[0] += kept(v.x);
          s[0] += kept(v.y);
          s[0] += kept(v.z);
          s[0] += kept(v.w);
        }
        reduce<C, T, AddF, 1>(s, cx);
        total = s[0];
      } else {
        // each CTA's argmax, then the cluster's in rank 0
        float best;
        int best_i;
        draw<T, false>(real, [&](int i, float& sc, int& j) {
          const float kv = kept(reinterpret_cast<const float*>(sx)[i]);
          j = start + i;
          sc = kv > 0.f ? gumbel_score(kv, base, j) : -CUDART_INF_F;
        }, best, best_i, red);
        const int buf = cx.phase & 1;
        ++cx.cluster_passes;
        if (threadIdx.x == 0) {  // to rank 0's slot for this rank
          *cl.map_shared_rank(&red.slot[buf][rank][0], 0) =
              __float_as_uint(best);
          *cl.map_shared_rank(&red.slot[buf][rank][1], 0) = uint32_t(best_i);
        }
        cl.sync();
        if (rank == 0 && threadIdx.x == 0) {
          for (int r = 1; r < C; ++r)
            arg_better(best, best_i, __uint_as_float(red.slot[buf][r][0]),
                       int(red.slot[buf][r][1]));
          out_tok[row] = best_i;
        }
      }
    }
    if (out_mode == kRenorm) {
      for (int q = threadIdx.x; q < n4; q += T) {
        const float4 v = sx[q];
        const float e[4] = {kept(v.x) / total, kept(v.y) / total,
                            kept(v.z) / total, kept(v.w) / total};
        store4(o, ovec, q, real, e);
      }
    }
  }
  if (stats != nullptr && rank == 0 && threadIdx.x == 0) {
    stats[3 * row] = cx.cluster_passes;
    stats[3 * row + 1] = cx.local_steps;
    stats[3 * row + 2] = n_list;
  }
  cl.sync();  // no CTA's shared memory goes while another may read it
}

// Dynamic shared memory of a cluster CTA: the slice and the gathered list
// (values and indices).
int cluster_smem_bytes(int slice) {
  return int(sizeof(float)) * (slice + 2 * kGather);
}

constexpr auto kClusterKernel = family_cluster_kernel<kCluster, kLevels,
                                                      kThreads>;

cudaError_t cluster_config(int batch, int slice, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const int bytes = cluster_smem_bytes(slice);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kCluster, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(bytes);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(
      kClusterKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ================================================================= streaming

constexpr int kStreamThreads = 1024;
constexpr int kStreamWarps = kStreamThreads / 32;

struct Reduce {
  float f[kStreamWarps];
  int i[kStreamWarps];
};

// Block-wide reductions; every thread gets the result.
__device__ float block_sum(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[warp] = v;
  __syncthreads();
  v = lane < kStreamWarps ? r.f[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ int block_count(int v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.i[warp] = v;
  __syncthreads();
  v = lane < kStreamWarps ? r.i[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_max(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[warp] = v;
  __syncthreads();
  v = lane < kStreamWarps ? r.f[lane] : -CUDART_INF_F;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_min(float v, Reduce& r) {
  return -block_max(-v, r);
}

__device__ int block_argmax(float v, int i, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
               __shfl_xor_sync(0xffffffffu, i, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { r.f[warp] = v; r.i[warp] = i; }
  __syncthreads();
  v = lane < kStreamWarps ? r.f[lane] : -CUDART_INF_F;
  i = lane < kStreamWarps ? r.i[lane] : 0x7fffffff;
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
               __shfl_xor_sync(0xffffffffu, i, o));
  return i;
}

// Pivot by bisection on f(x) over [lo, hi]: count mode keeps
// count(f > mid) >= k, mass mode keeps sum(f > mid ? f : 0) >= p.
template <typename F>
__device__ float bisect(const float* x, int vocab, F f, bool count_mode,
                        int k, float p, float lo, float hi, Reduce& r) {
  for (int it = 0; it < kIters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    bool ok;
    if (count_mode) {
      int c = 0;
      for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
        c += f(x[j]) > mid;
      ok = block_count(c, r) >= k;
    } else {
      float s = 0.f;
      for (int j = threadIdx.x; j < vocab; j += kStreamThreads) {
        const float v = f(x[j]);
        s += v > mid ? v : 0.f;
      }
      ok = block_sum(s, r) >= p;
    }
    if (ok) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename F>
__device__ float row_max(const float* x, int vocab, F f, Reduce& r) {
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
    m = fmaxf(m, f(x[j]));
  return block_max(m, r);
}

__global__ void __launch_bounds__(kStreamThreads)
family_stream_kernel(const float* __restrict__ xs,
                     const int* __restrict__ ks,
                     const float* __restrict__ ps, int vocab, int filt,
                     int out_mode, const int* __restrict__ seed_dev,
                     int seed_val, int* __restrict__ out_tok,
                     float* __restrict__ out_row) {
  __shared__ Reduce red;
  const int row = blockIdx.x;
  const float* x = xs + size_t(row) * vocab;
  const int k = ks[row];
  const float p = ps[row];
  const auto ident = [](float v) { return v; };

  if (out_mode == kMaskLogits) {
    float mn = CUDART_INF_F;
    for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
      mn = fminf(mn, x[j]);
    const float lo0 = block_min(mn, red);
    const float hi0 = row_max(x, vocab, ident, red);
    float t = bisect(x, vocab, ident, true, k, 0.f, lo0, hi0, red);
    if (k >= vocab) t = t - 1.f;
    float* o = out_row + size_t(row) * vocab;
    for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
      o[j] = x[j] > t ? x[j] : -CUDART_INF_F;
    return;
  }

  Stage1 st{-1.f, 1.f, 0.f};
  float tk = -1.f;  // top-k pivot on the raw row
  if (filt == kTopK || filt == kJoint || filt == kSeq) {
    const float hi = row_max(x, vocab, ident, red);
    tk = bisect(x, vocab, ident, true, k, 0.f, 0.f, hi, red);
    if (k >= vocab) tk = -1.f;
  }
  if (filt == kSeq) {
    float s = 0.f;
    for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
      s += x[j] > tk ? x[j] : 0.f;
    const float s1 = block_sum(s, red);
    st = Stage1{tk, s1, 0.f / s1};
  }
  // the row after the first filter stage: probs, or for "seq" stage 1
  const auto stage1 = [&](float v) { return filt == kSeq ? st(v) : v; };
  float tp = -1.f;  // top-p pivot on the stage-1 row
  if (filt == kTopP || filt == kJoint || filt == kSeq) {
    const float hi = row_max(x, vocab, stage1, red);
    tp = bisect(x, vocab, stage1, false, 0, p, 0.f, hi, red);
    if (p >= 1.f) tp = -1.f;
  }
  float minp_t = 0.f;
  if (filt == kMinP) minp_t = p * row_max(x, vocab, ident, red);
  const Keep keep{filt, tk, tp, minp_t};

  if (out_mode == kRenorm) {
    float s = 0.f;
    for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
      s += keep(stage1(x[j]));
    const float total = block_sum(s, red);
    float* o = out_row + size_t(row) * vocab;
    for (int j = threadIdx.x; j < vocab; j += kStreamThreads)
      o[j] = keep(stage1(x[j])) / total;
    return;
  }

  const uint32_t base =
      noise_base(seed_dev != nullptr ? *seed_dev : seed_val, row);
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int j = threadIdx.x; j < vocab; j += kStreamThreads) {
    const float v = keep(stage1(x[j]));
    arg_better(best, best_i, v > 0.f ? gumbel_score(v, base, j)
                                     : -CUDART_INF_F, j);
  }
  const int tok = block_argmax(best, best_i, red);
  if (threadIdx.x == 0) out_tok[row] = tok;
}

// CTA slice of the cluster route: ceil(vocab / kCluster) rounded up to a
// multiple of 4 * kThreads, or 0 if it does not fit in shared memory (the
// streaming route).
int slice_of(int vocab) {
  const long long per = (vocab + kCluster - 1) / kCluster;
  const long long step = 4LL * kThreads;
  const long long s = (per + step - 1) / step * step;
  return s * 4 > kMaxSliceBytes ? 0 : int(s);
}

}  // namespace

// The route is the cluster route where a row's slices fit in shared
// memory, else the streaming route. The seed is *seed_dev when seed_dev is
// not null, else seed_val. With `stats`, a cluster-route launch writes row
// r's cluster reductions, warp-0 bisection steps and gathered list length
// (-1: none) to stats[3r..3r+2]; the streaming route leaves it.
extern "C" int fi_sampling_family(const float* x, const int* k, const float* p,
                                  int batch, int vocab, int filt, int out_mode,
                                  const int* seed_dev, int seed_val,
                                  int* out_tok, float* out_row, int* stats,
                                  void* stream) {
  if (batch <= 0 || batch > 65535 || vocab <= 0 || filt < kNone ||
      filt > kSeq || out_mode < kSample || out_mode > kMaskLogits)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slice = slice_of(vocab);
  if (slice == 0) {
    family_stream_kernel<<<batch, kStreamThreads, 0, s>>>(
        x, k, p, vocab, filt, out_mode, seed_dev, seed_val, out_tok, out_row);
    return int(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(batch, slice, s, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kClusterKernel, x, k, p, vocab, slice,
                             filt, out_mode, seed_dev, seed_val, out_tok,
                             out_row, stats);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// The route `fi_sampling_family` takes for rows of `vocab` entries: info =
// {CTAs a row (0: the streaming route), bisection steps a pass, threads a
// CTA, a CTA's slice (entries), clusters the card runs at once
// (cudaOccupancyMaxActiveClusters; 0 on the streaming route)}.
extern "C" int fi_sampling_route(int vocab, int* info) {
  const int slice = slice_of(vocab);
  info[0] = slice == 0 ? 0 : kCluster;
  info[1] = slice == 0 ? 1 : kLevels;
  info[2] = slice == 0 ? kStreamThreads : kThreads;
  info[3] = slice;
  info[4] = 0;
  if (slice == 0) return int(cudaSuccess);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(1, slice, nullptr, cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&info[4], kClusterKernel, &cfg);
  return int(err);
}
