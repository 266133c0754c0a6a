// The paged attention's split-KV merge and output unpack, for Hopper
// (sm_90a): one launch a call of run_device_plan, after the paged kernel.
//
// Replaces no TPU kernel. The JAX package merges a plan's split-KV partials
// with XLA ops (flashinfer_tpu/ops/attention/state.py gather_merge_states,
// then run_device_plan's out_map gather and GQA transpose), which XLA fuses
// into the step's program. Run op by op in PyTorch, the same composition
// (paged_merge_plain, ops/attention/kernels/paged_merge.py) is about
// 26 + 4 S launches of a few microseconds each at S splits: the largest user
// of device time in a long-context decode step. This kernel does it at once:
//
//   out[t, h, :] = sum_s w_s o_s / sum_s w_s,  w_s = exp(lse_s - max_s lse_s)
//   lse_out[t, h] = max_s lse_s + log(sum_s w_s)
//
// over the partials s of packed row r = out_map[t * group + h % group] and
// kv head h / group: o_s = partial_o[p / tile_q, h / group, p % tile_q],
// p = merge_src[r, s], for each s with p >= 0 (a partial with lse -inf
// weighs 0). A row with no partial of finite lse gives 0 and -inf. The
// arithmetic is the plain version's, step by step: f32, the weighted sum
// over the sources in order, products and sums rounded separately (no fused
// multiply-add), one IEEE division, one rounding to the partials' dtype. So
// one split reproduces its partial bit for bit, and more differ from the
// plain version only in the order in which the weights are summed.
//
// What bounds it on the H100: latency more than bytes. A long-context decode
// layer (32 requests of 3072-9216 keys at chunk 512: 32 splits, 12.5 of them
// used on average; 8 kv heads, dv 128 bf16) reads 3.3 MB of partials and
// writes 256 KB, 1.1 us at 3.35 TB/s, through a chain of dependent loads
// (out_map, merge_src, lse, o). The design:
//   * a group of lanes an output (token, head), each lane one 16-byte vector
//     of its dv (two where dv is wider than 32 vectors), so the partials are
//     read once in 16-byte loads and the output is written once, in the
//     caller's [nnz, hq, head_dim_vo]; 128 threads a CTA, so a decode of
//     1024 outputs spreads over 128 CTAs and a prefill's 65536 stream;
//   * every lane sums over the sources in order, 8 at a time (4 where it
//     holds two vectors), their indices, lse and vectors loaded before any
//     is used; a row of at most 8 splits (a prefill, a short decode) is thus
//     one round of loads and takes its largest lse from registers; with
//     more, the group's lanes first share the row's lse (a butterfly of
//     shuffles: a max is exact in any order);
//   * merge_src's -1 entries are skipped: only the partials a row has are
//     read;
//   * at most 128 registers a thread (kMinBlocks CTAs an SM);
//   * programmatic dependent launch, as csrc/norm.cu: the launch may overlap
//     the paged kernel's tail and waits (griddepcontrol.wait) before it
//     reads anything.
// Measured (PERF.md, chip_smoke.check_paged_merge, one CUDA graph, Mistral-7B
// heads): 0.0102 ms at that decode (bound 0.0011) against the plain
// composition's 0.381; 0.0644 ms at a 2048-token prefill of 4 splits (59.5
// MB, bound 0.0178) against 0.727. A first build that held two vectors a
// lane whatever dv, with no register bound (193 registers), took 0.141 ms at
// the prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a CTA
constexpr int kMinBlocks = 4;  // CTAs an SM at least: <= 128 registers
constexpr int kMaxVecs = 2;    // 16-byte vectors of dv a lane holds
constexpr int kUnroll = 8;     // sources in flight together at a vector a lane

struct Args {
  const void* o;       // [T, kvh, tq, dv] partials
  const float* lse;    // [T, kvh, tq]
  const int* src;      // [rows, splits] flat partial rows, -1 for none
  const int* out_map;  // [nnz * group] packed row of (token, head in group)
  void* out;           // [nnz, kvh * group, dv_out]
  float* lse_out;      // [nnz, kvh * group], or null
  long long n_out;     // nnz * kvh * group
  int group, kvh, tq, dv, dv_out, splits, parts, lanes;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// The row of partial p (flat index item * tq + row) of kv head kh in the
// [T, kvh, tq] arrays; p is clamped into the partials.
__device__ __forceinline__ long long part_row(const Args& a, int p, int kh) {
  p = min(p, a.parts - 1);
  return (static_cast<long long>(p / a.tq) * a.kvh + kh) * a.tq + p % a.tq;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    paged_merge_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = kUnroll / VPT;  // sources whose loads are in flight
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x % a.lanes;  // a.lanes: a power of two <= 32
  const long long idx =
      static_cast<long long>(blockIdx.x) * (kThreads / a.lanes) +
      threadIdx.x / a.lanes;
  const bool live = idx < a.n_out;  // no early exit: the shuffles need all
  const int hq = a.kvh * a.group;
  const int h = live ? static_cast<int>(idx % hq) : 0;
  const int kh = h / a.group;
  const int nvec = a.dv / VEC;
  const T* o = static_cast<const T*>(a.o);
  griddep_wait();  // out_map, merge_src and the partials may be just written
  const int row =
      live ? a.out_map[(idx / hq) * a.group + h % a.group] : 0;
  const int* src = a.src + static_cast<long long>(row) * a.splits;

  // U sources from s0: their partials' rows, lse and this lane's vectors,
  // all loads issued before any is used
  int p[U];
  float l[U];
  P v[U][VPT];
  auto load = [&](int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      p[u] = live && s0 + u < a.splits ? src[s0 + u] : -1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p[u] < 0) continue;
      const long long r = part_row(a, p[u], kh);
      l[u] = a.lse[r];
      const P* orow = reinterpret_cast<const P*>(o + r * a.dv);
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        if (lane + i * a.lanes < nvec) v[u][i] = orow[lane + i * a.lanes];
    }
  };
  float acc[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;
  float den = 0.f;
  // the loaded sources into the sums, in order
  auto add = [&](float m_safe) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p[u] < 0) continue;
      const float w = l[u] == -CUDART_INF_F ? 0.f : expf(l[u] - m_safe);
      den = __fadd_rn(den, w);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (lane + i * a.lanes >= nvec) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[i][k] =
              __fadd_rn(acc[i][k], __fmul_rn(to_f32(v[u][i].v[k]), w));
      }
    }
  };

  load(0);
  float m = -CUDART_INF_F;
  if (a.splits <= U) {  // every source is in registers
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p[u] >= 0) m = fmaxf(m, l[u]);
  } else {  // the group's lanes share the row's lse, then a butterfly
    if (live) {
      for (int s = lane; s < a.splits; s += a.lanes) {
        const int q = src[s];
        if (q >= 0) m = fmaxf(m, a.lse[part_row(a, q, kh)]);
      }
    }
    for (int x = 1; x < a.lanes; x <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
  }
  const float m_safe = m == -CUDART_INF_F ? 0.f : m;
  add(m_safe);
  for (int s0 = U; s0 < a.splits; s0 += U) {
    load(s0);
    add(m_safe);
  }
  griddep_launch_dependents();
  if (!live) return;

  const float d = den > 0.f ? den : 1.f;
  T* orow = static_cast<T*>(a.out) + idx * a.dv_out;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + i * a.lanes;
    if (c >= nvec || c * VEC >= a.dv_out) continue;
    P r;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      r.v[k] = from_f32<T>(__fdiv_rn(acc[i][k], d));
    if (a.dv_out % VEC == 0) {
      *reinterpret_cast<P*>(orow + c * VEC) = r;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (c * VEC + k < a.dv_out) orow[c * VEC + k] = r.v[k];
    }
  }
  if (a.lse_out != nullptr && lane == 0)
    a.lse_out[idx] = den > 0.f ? m_safe + logf(d) : -CUDART_INF_F;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  const long long per_cta = kThreads / a.lanes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.n_out + per_cta - 1) / per_cta));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a lane holds a vector of dv, or two where dv is wider than 32 of them
  return a.dv / (16 / int(sizeof(T))) > 32
             ? cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, 2>, a)
             : cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, 1>, a);
}

}  // namespace

// Merges the split-KV partials o [T, kvh, tile_q, dv] (dtype 0 f32, 1 bf16)
// and lse [T, kvh, tile_q] f32 of the rows merge_src [rows, splits] lists
// (int32 flat partial rows, -1 for none) and writes them unpacked: out [nnz,
// kvh * group, dv_out] in o's dtype, the first dv_out of dv columns, and
// lse_out [nnz, kvh * group] f32 unless it is null. dv is a multiple of the
// 16-byte vector and at most 64 of them.
extern "C" int fi_paged_merge(const void* o, const float* lse,
                              const int* merge_src, const int* out_map,
                              void* out, float* lse_out, int nnz, int group,
                              int T, int kvh, int tile_q, int dv, int dv_out,
                              int splits, int dtype, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (nnz <= 0 || group <= 0 || T <= 0 || kvh <= 0 || tile_q <= 0 ||
      splits <= 0 || dv <= 0 || dv % vec != 0 || dv / vec > 32 * kMaxVecs ||
      dv_out <= 0 || dv_out > dv || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  int lanes = 1;
  while (lanes < 32 && lanes < dv / vec) lanes <<= 1;
  const Args a{o,      lse,         merge_src,
               out_map, out,        lse_out,
               static_cast<long long>(nnz) * kvh * group,
               group,  kvh,         tile_q,
               dv,     dv_out,      splits,
               T * tile_q, lanes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(a, s)
                                     : launch<float>(a, s);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
