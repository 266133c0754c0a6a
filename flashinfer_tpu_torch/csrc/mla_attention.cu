// Matrix-absorbed MLA paged attention over a planned work list, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_mla_kernel` (flashinfer_tpu/ops/attention/
// mla.py:67, launched by _mla_paged_run :372). One shared KV stream: a key
// is a compressed row ckv (d_ckv, 512 in DeepSeek) plus a rope row kpe
// (d_kpe, 64), and all num_heads query heads are packed as rows (a row is a
// (token, head) pair, group = num_heads). score = q_nope.ckv + q_pe.kpe,
// out = P.ckv: ckv is read once and serves as V. It reads the int32 plan
// (REQ, QO_TILE, QO_START, KV_START, KV_END, KV_PAGE_START, Q_POS_BASE of T
// items) and writes the split-KV partials o [T, tile_q, d_ckv] in q's dtype
// and lse [T, tile_q] f32 (natural log; o = 0, lse = -inf for padding
// items, empty ranges and rows that see no key).
//
// Numerics follow the TPU kernel: scores in f32 from exactly converted keys
// (bf16, f32, e4m3 through the hardware fp8 conversion, or linear int8),
// the softmax in base 2 with log2(e) folded into the scale, P rounded to
// bf16 before P.V for every cache but f32 (the TPU kernel feeds its MXU
// with P in V's dtype, and its 8-bit caches decode to bf16), q rounded to
// bf16 for e4m3 caches. The wrapper folds the 8-bit scales into sm_scale
// and v_scale and prescales q_pe when kpe_scale != ckv_scale.
//
// What bounds it on the H100: at decode the bytes, the ckv and kpe of every
// key read once (1152 B a token in bf16, shared by all 16 heads); at causal
// prefill the operations, which this first version runs on the CUDA cores
// in f32, not on the tensor cores. Design: one CTA of eight warps per (work
// item, block of 8 or 16 q rows); the TPU's sequential grid over items and
// sub-tiles becomes parallel CTAs, and the item's KV chunk is a loop inside
// the CTA over 32-key tiles gathered page by page through kv_indices with
// 16-byte loads (a kpe row of 64 bf16 is 128 B: the loads run over (key,
// vector) pairs, so no warp sweep has to fit one row). A tile is converted
// to f32 once into shared memory with an odd row stride (conflict-free dot
// products, lane = key) and then reused as V. The f32 accumulator [rows,
// d_ckv] lives in registers, two columns a thread; the q block, the tile
// and P take ~113 KB of dynamic shared memory at 16 rows, above the 48 KB
// default, so the launch opts in. Tensor-core MMA, TMA and a pipelined tile
// ring are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;     // keys per tile: one per lane
constexpr int kMaxCkv = 2 * kThreads;  // P.V: columns tid and tid + 256
constexpr int kMaxKpe = 128;

enum PlanRow {
  kReq = 0, kQoTile = 1, kQoStart = 3, kKvStart = 5, kKvEnd = 6,
  kKvPageStart = 7, kQPosBase = 9,
};

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kI8 = 3 };

struct Params {
  const void* q_ckv;  // [q_rows, d_ckv]
  const void* q_pe;   // [q_rows, d_kpe]
  const void* ckv;    // [P, page_size, d_ckv]
  const void* kpe;    // [P, page_size, kpe_stride]; the first d_kpe are read
  const int* plan;    // [12 * T]
  const int* kv_indices;
  void* o;            // [T, tile_q, d_ckv]
  float* lse;         // [T, tile_q]
  int T, q_rows, tile_q, d_ckv, d_kpe, kpe_stride, page_size, group, causal;
  float scale_log2;   // sm_scale (8-bit scale folded in) * log2(e)
  float v_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (size_t(rows) * d          // q block
                          + size_t(kTileK) * (d + 1)  // key tile, odd stride
                          + size_t(rows) * kTileK     // P
                          + 3 * size_t(rows));        // alpha, final l and m
}

// Gather 32 keys (ckv then kpe, one f32 row of d + 1 each) into shared
// memory. Keys past the item's span are zero-filled (their P is 0 too).
template <typename KT>
__device__ __forceinline__ void load_kv_tile(const Params& p, int page0,
                                             int t0, int span, float* kv_s) {
  constexpr int kVec = 16 / sizeof(KT);
  const int d = p.d_ckv + p.d_kpe;
  const int vc = p.d_ckv / kVec, vp = p.d_kpe / kVec;
  const KT* ckv = static_cast<const KT*>(p.ckv);
  const KT* kpe = static_cast<const KT*>(p.kpe);
  for (int i = threadIdx.x; i < kTileK * (vc + vp); i += kThreads) {
    const int j = i / (vc + vp), v = i % (vc + vp);
    const int lt = t0 + j;
    const int col = v < vc ? v * kVec : p.d_ckv + (v - vc) * kVec;
    float f[kVec];
    if (lt < span) {
      const int page = p.kv_indices[page0 + lt / p.page_size];
      const size_t tok = size_t(page) * p.page_size + lt % p.page_size;
      const KT* src = v < vc ? ckv + tok * p.d_ckv + v * kVec
                             : kpe + tok * p.kpe_stride + (v - vc) * kVec;
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const KT* x = reinterpret_cast<const KT*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = to_f32(x[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    float* dst = kv_s + j * (d + 1) + col;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = f[e];
  }
}

template <typename QT, typename KT, int ROWS>
__global__ void __launch_bounds__(kThreads)
mla_attention_kernel(const Params p) {
  static_assert(ROWS % kWarps == 0, "softmax rows are split over the warps");
  constexpr int RPW = ROWS / kWarps;
  // the TPU kernel's MXU operands: P in V's dtype (bf16 unless the cache is
  // f32), and q in bf16 against its e4m3 decode
  constexpr bool kRoundP = !std::is_same<KT, float>::value;
  constexpr bool kRoundQ = std::is_same<KT, __nv_fp8_e4m3>::value;
  extern __shared__ float smem[];
  const int d = p.d_ckv + p.d_kpe, ds = d + 1;
  float* q_s = smem;
  float* kv_s = q_s + ROWS * d;
  float* p_s = kv_s + kTileK * ds;
  float* alpha_s = p_s + ROWS * kTileK;
  float* l_s = alpha_s + ROWS;
  float* m_s = l_s + ROWS;

  const int w = blockIdx.x, row0 = blockIdx.y * ROWS;
  const int T = p.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int req = p.plan[kReq * T + w];
  const int kv_start = p.plan[kKvStart * T + w];
  const int span = p.plan[kKvEnd * T + w] - kv_start;
  QT* o = static_cast<QT*>(p.o) + (size_t(w) * p.tile_q + row0) * p.d_ckv;
  float* lse = p.lse + size_t(w) * p.tile_q + row0;

  if (req < 0 || span <= 0) {  // padding item: the merge identity
    for (int i = tid; i < ROWS * p.d_ckv; i += kThreads) o[i] = from_f32<QT>(0.f);
    if (tid < ROWS) lse[tid] = -CUDART_INF_F;
    return;
  }
  const int qo_tile = p.plan[kQoTile * T + w];
  const int qo_start = p.plan[kQoStart * T + w];
  const int page0 = p.plan[kKvPageStart * T + w];
  const int q_pos_base = p.plan[kQPosBase * T + w];

  const QT* q_ckv = static_cast<const QT*>(p.q_ckv);
  const QT* q_pe = static_cast<const QT*>(p.q_pe);
  for (int i = tid; i < ROWS * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const size_t qr = size_t(qo_start) + row0 + r;
    const float x = c < p.d_ckv ? to_f32(q_ckv[qr * p.d_ckv + c])
                                : to_f32(q_pe[qr * p.d_kpe + c - p.d_ckv]);
    q_s[i] = kRoundQ ? round_bf16(x) : x;
  }

  int q_tok[RPW];
  float m_reg[RPW], l_reg[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    q_tok[r] = q_pos_base + (qo_tile * p.tile_q + row0 + warp * RPW + r) / p.group;
    m_reg[r] = -CUDART_INF_F;
    l_reg[r] = 0.f;
  }
  float acc[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int t0 = 0; t0 < span; t0 += kTileK) {
    __syncthreads();  // the previous tile and P are consumed
    load_kv_tile<KT>(p, page0, t0, span, kv_s);
    __syncthreads();

    // scores of this warp's rows against key `lane`, softmax in the warp
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = kv_s + lane * ds;
    for (int c = 0; c < d; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2], k3 = krow[c + 3];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp * RPW + r) * d + c);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }
    const int lt = t0 + lane;
    const int kv_pos = kv_start + lt;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const bool keep = lt < span && (!p.causal || kv_pos <= q_tok[r]);
      const float x = keep ? s[r] * p.scale_log2 : -CUDART_INF_F;
      const float m_new = fmaxf(m_reg[r], warp_max(x));
      const float m_safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float e = keep ? exp2f(x - m_safe) : 0.f;
      const float alpha = (m_reg[r] == -CUDART_INF_F) ? 0.f : exp2f(m_reg[r] - m_safe);
      l_reg[r] = l_reg[r] * alpha + warp_sum(e);
      m_reg[r] = m_new;
      p_s[row * kTileK + lane] = kRoundP ? round_bf16(e) : e;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // P.V with V = the ckv part of the tile; thread tid owns columns tid
    // and tid + 256
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = tid + ci * kThreads;
      if (c >= p.d_ckv) break;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][ci] *= alpha_s[r];
      for (int j = 0; j < kTileK; j += 4) {
        const float v0 = kv_s[j * ds + c], v1 = kv_s[(j + 1) * ds + c];
        const float v2 = kv_s[(j + 2) * ds + c], v3 = kv_s[(j + 3) * ds + c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 pv = *reinterpret_cast<const float4*>(p_s + r * kTileK + j);
          acc[r][ci] = fmaf(pv.x, v0, acc[r][ci]);
          acc[r][ci] = fmaf(pv.y, v1, acc[r][ci]);
          acc[r][ci] = fmaf(pv.z, v2, acc[r][ci]);
          acc[r][ci] = fmaf(pv.w, v3, acc[r][ci]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      l_s[warp * RPW + r] = l_reg[r];
      m_s[warp * RPW + r] = m_reg[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < 2; ++ci) {
    const int c = tid + ci * kThreads;
    if (c >= p.d_ckv) break;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float l = l_s[r];
      o[size_t(r) * p.d_ckv + c] =
          from_f32<QT>(acc[r][ci] / (l > 0.f ? l : 1.f) * p.v_scale);
    }
  }
  if (tid < ROWS) {
    const float l = l_s[tid], m = m_s[tid];
    const float m_safe = (m == -CUDART_INF_F) ? 0.f : m;
    lse[tid] = l > 0.f ? m_safe * 0.6931471805599453f + logf(l) : -CUDART_INF_F;
  }
}

template <typename QT, typename KT, int ROWS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = mla_attention_kernel<QT, KT, ROWS>;
  const size_t bytes = smem_bytes(ROWS, p.d_ckv + p.d_kpe);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.T, p.tile_q / ROWS);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.tile_q >= 16) return launch<QT, KT, 16>(p, stream);
  return launch<QT, KT, 8>(p, stream);
}

template <typename QT>
cudaError_t launch_kv(const Params& p, int kv_dtype, cudaStream_t stream) {
  if (kv_dtype == kE4M3) return launch_rows<QT, __nv_fp8_e4m3>(p, stream);
  if (kv_dtype == kI8) return launch_rows<QT, int8_t>(p, stream);
  return launch_rows<QT, QT>(p, stream);  // caller checked kv dtype == q dtype
}

}  // namespace

extern "C" int fi_mla_attention(
    const void* q_ckv, const void* q_pe, const void* ckv, const void* kpe,
    const int* plan, const int* kv_indices, void* o, float* lse, int T,
    int q_rows, int tile_q, int d_ckv, int d_kpe, int kpe_stride,
    int page_size, int group, float sm_scale, float v_scale, int causal,
    int q_dtype, int kv_dtype, void* stream) {
  if (T <= 0 || tile_q < 8 || tile_q % 8 != 0 || (tile_q >= 16 && tile_q % 16) ||
      d_ckv <= 0 || d_ckv > kMaxCkv || d_ckv % 16 != 0 || d_kpe <= 0 ||
      d_kpe > kMaxKpe || d_kpe % 16 != 0 || kpe_stride < d_kpe)
    return int(cudaErrorInvalidValue);
  if (!(kv_dtype == q_dtype || kv_dtype == kE4M3 || kv_dtype == kI8))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q_ckv = q_ckv; p.q_pe = q_pe; p.ckv = ckv; p.kpe = kpe; p.plan = plan;
  p.kv_indices = kv_indices; p.o = o; p.lse = lse;
  p.T = T; p.q_rows = q_rows; p.tile_q = tile_q; p.d_ckv = d_ckv;
  p.d_kpe = d_kpe; p.kpe_stride = kpe_stride; p.page_size = page_size;
  p.group = group; p.causal = causal;
  p.scale_log2 = float(double(sm_scale) * 1.4426950408889634);
  p.v_scale = v_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kBF16) err = launch_kv<__nv_bfloat16>(p, kv_dtype, s);
  else if (q_dtype == kF32) err = launch_kv<float>(p, kv_dtype, s);
  else err = cudaErrorInvalidValue;
  return int(err);
}
