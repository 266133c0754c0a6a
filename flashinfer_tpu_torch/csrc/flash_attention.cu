// Dense single-request attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (flashinfer_tpu/ops/attention/
// kernels/flash.py:93, launched by flash_attention_dense :255). It computes
// what that kernel computes: logits q.k * sm_scale with f32 accumulation;
// the variant's transform (ALiBi slope[h] * (kv_pos - q_pos), then the soft
// cap cap * tanh(x / cap); or the sigmoid 1 / (1 + exp(-(x * scale +
// bias)))); the mask (kv_pos < kv_len, causal kv_pos <= q_pos with query i
// at q_pos = kv_len - qo_len + i, the window kv_pos >= q_pos - window_left,
// the custom mask as packed bits, "big" order, over [qo_len, kv_len]);
// online softmax in base 2 (log2(e) folded in after the transform) with P
// rounded to v's dtype before P.V, as the TPU feeds its MXU; the sink added
// once at the end. A row that sees no key gives o = 0 and lse = -inf (o and
// lse 0 for the sigmoid, whose weights simply add). lse is natural-log.
//
// Outputs: with one split, o [qo_len, hq, dv] in q's dtype and lse
// [qo_len, hq]; with S > 1 splits of the key range, f32 partial states
// o [qo_len, S, hq, dv] and lse [qo_len, S, hq] that the wrapper merges
// (the sink joins split 0's state, so the merge adds it once).
//
// What bounds it on the H100: at prefill the operations (4 * d flops a
// (query, key) pair; Llama-3-8B's 8192-token causal prefill is 0.55 TFLOP,
// 0.56 ms at 989 TFLOP/s against 0.05 ms of bytes), at decode the K/V
// bytes (one query token sees the whole cache: 134 MB at 32K tokens).
// Design: bf16 runs on the tensor cores (mma.sync m16n8k16, f32
// accumulators in registers). A CTA of four warps takes 64 GQA-packed query
// rows of one kv head (row = token * group + head in group, 16 rows a
// warp), so each K/V tile serves the whole head group. 64-key K and V tiles
// are staged in shared memory with cp.async, double-buffered, rows padded
// by 16 bytes so the fragment loads are free of bank conflicts; Q.K^T
// leaves S in the accumulator layout that P.V takes as its A operand, so P
// never goes through shared memory, and V's B fragments come from
// ldmatrix.trans. The key loop runs from the window's first needed tile to
// the causal frontier of the CTA's last token; only the tiles at the edges
// (the diagonal, the window's start, the end of the KV, a custom mask) test
// each (row, key); the CTAs with the most keys start first. When the (row
// tile, kv head) CTAs would leave most SMs idle (decode: one token is 8
// CTAs at Llama-3-8B), the key range is split across CTAs (the wrapper
// picks the count) and merged by the wrapper.
// f32 runs on the CUDA cores in f32 (16 rows a CTA), so f32 keeps f32
// accuracy. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 64;
constexpr int kRowsTc = 64;   // packed rows a CTA, tensor-core kernel
constexpr int kRowsF32 = 16;  // packed rows a CTA, CUDA-core kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;          // [qo_len, hq, d] through q_st / q_sh
  const void* k;          // [kv_len, hkv, d] through k_st / k_sh
  const void* v;          // [kv_len, hkv, dv] through v_st / v_sh
  const uint8_t* mask;    // packed bits or null
  const float* alibi;     // [hq] or null
  const float* sink;      // [hq] or null; applied by split 0
  void* o;
  float* lse;
  long long q_st, q_sh, k_st, k_sh, v_st, v_sh;  // strides in elements
  int qo_len, kv_len, hq, hkv, group, d, dv;
  int causal, window_left, splits, sigmoid;
  float sm_scale, scale_log2, soft_cap, sig_scale, sig_bias;
};

// One packed query row: its token (-1 past the end), q head, absolute
// position and ALiBi slope.
struct Row {
  int tok, head, q_pos;
  float slope;
};

__device__ __forceinline__ Row row_info(const Params& p, int kvh, int packed) {
  Row r;
  const bool real = packed < p.qo_len * p.group;
  r.tok = real ? packed / p.group : -1;
  r.head = kvh * p.group + (real ? packed % p.group : 0);
  r.q_pos = p.kv_len - p.qo_len + (real ? r.tok : 0);
  r.slope = p.alibi ? p.alibi[r.head] : 0.f;
  return r;
}

__device__ __forceinline__ bool keep(const Params& p, const Row& r, int kv) {
  if (r.tok < 0 || kv >= p.kv_len) return false;
  if (p.causal && kv > r.q_pos) return false;
  if (p.window_left >= 0 && kv < r.q_pos - p.window_left) return false;
  if (p.mask) {
    const long long bit = (long long)r.tok * p.kv_len + kv;
    if (!((p.mask[bit >> 3] >> (7 - int(bit & 7))) & 1)) return false;
  }
  return true;
}

// A kept logit as the softmax takes it (base 2), or the sigmoid's weight.
template <bool kGeneral>
__device__ __forceinline__ float transform(const Params& p, const Row& r,
                                           int kv, float s) {
  if (!kGeneral) return s * p.scale_log2;
  float x = s * p.sm_scale;
  if (p.sigmoid) return 1.f / (1.f + expf(-(x * p.sig_scale + p.sig_bias)));
  if (p.alibi) x += r.slope * float(kv - r.q_pos);
  if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
  return x * kLog2e;
}

// The key tiles [t0, t1) that rows [row0, row0 + rows) of this split need.
__device__ __forceinline__ void key_tiles(const Params& p, int row0, int rows,
                                          int split, int& t0, int& t1) {
  const int last = min(row0 + rows, p.qo_len * p.group) - 1;
  const int off = p.kv_len - p.qo_len;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, off + last / p.group + 1);
  int kv_begin = 0;
  if (p.window_left >= 0)
    kv_begin = max(0, off + row0 / p.group - p.window_left);
  t0 = kv_begin / kTileK;
  t1 = kv_end > kv_begin ? (kv_end + kTileK - 1) / kTileK : t0;
  if (p.splits > 1) {
    const int per = (t1 - t0 + p.splits - 1) / p.splits;
    const int s0 = t0 + split * per;
    t1 = min(t1, s0 + per);  // t1 <= t0: an empty split
    t0 = s0;
  }
}

// Whether every (row, key) of key tile kt is kept for the real rows
// (tokens tok_lo..tok_hi); rows past the end compute values nobody stores.
__device__ __forceinline__ bool tile_full(const Params& p, int kt, int tok_lo,
                                          int tok_hi) {
  const int k_lo = kt * kTileK, k_hi = k_lo + kTileK - 1;
  const int off = p.kv_len - p.qo_len;
  return !p.mask && k_hi < p.kv_len && !(p.causal && k_hi > off + tok_lo) &&
         !(p.window_left >= 0 && k_lo < off + tok_hi - p.window_left);
}

// Row offset of a state in o (times dv) and lse.
__device__ __forceinline__ size_t out_row(const Params& p, const Row& r,
                                          int split) {
  return p.splits == 1 ? size_t(r.tok) * p.hq + r.head
                       : (size_t(r.tok) * p.splits + split) * p.hq + r.head;
}

// Finish a row of a split from its base-2 max m and sum l: returns the
// factor its accumulator is multiplied by and writes its lse.
__device__ __forceinline__ float finish_row(const Params& p, const Row& r,
                                            int split, float m, float l,
                                            float* lse) {
  if (p.sigmoid) {
    *lse = 0.f;
    return 1.f;
  }
  float acc_scale = 1.f;
  if (p.sink && split == 0) {
    const float s2 = p.sink[r.head] * kLog2e;
    const float m_fin = fmaxf(m, s2);
    acc_scale = (m == -CUDART_INF_F) ? 0.f : exp2f(m - m_fin);
    l = l * acc_scale + exp2f(s2 - m_fin);
    m = m_fin;
  }
  const float m_safe = (m == -CUDART_INF_F) ? 0.f : m;
  *lse = l > 0.f ? m_safe * kLn2 + logf(l) : -CUDART_INF_F;
  return l > 0.f ? acc_scale / l : 0.f;
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

size_t tc_smem_bytes(int d, int dv) {
  return (size_t(kRowsTc + 2 * kTileK) * (d + 8) +
          size_t(2 * kTileK) * (dv + 8)) * sizeof(__nv_bfloat16);
}

template <int DV, bool kGeneral>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kN8 = DV / 8;  // output n8 fragments a warp
  constexpr int VS = DV + 8;   // V row stride in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, QS = d + 8;  // Q and K row stride
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kRowsTc][QS]
  bf16* sK = sQ + kRowsTc * QS;                  // [2][kTileK][QS]
  bf16* sV = sK + 2 * kTileK * QS;               // [2][kTileK][VS]

  const int tile = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = tile * kRowsTc, total = p.qo_len * p.group;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k) + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + kvh * p.v_sh;

  const int qv = d / 8;  // 16-byte vectors a Q/K row
  for (int i = tid; i < kRowsTc * qv; i += kThreads) {
    const int r = i / qv, c = (i % qv) * 8, pr = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (pr < total) {
      const int tok = pr / p.group, h = kvh * p.group + pr % p.group;
      x = *reinterpret_cast<const uint4*>(q + tok * p.q_st + h * p.q_sh + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * QS + c) = x;
  }

  int t0, t1;
  key_tiles(p, row0, kRowsTc, split, t0, t1);
  auto load_kv = [&](int kt, int buf) {
    bf16* dk = sK + buf * kTileK * QS;
    bf16* dv_ = sV + buf * kTileK * VS;
    const int key0 = kt * kTileK;
    for (int i = tid; i < kTileK * qv; i += kThreads) {
      const int r = i / qv, c = (i % qv) * 8, key = key0 + r;
      const bool ok = key < p.kv_len;
      cp_async16(dk + r * QS + c, k + (ok ? key : 0) * p.k_st + c, ok);
    }
    for (int i = tid; i < kTileK * (DV / 8); i += kThreads) {
      const int r = i / (DV / 8), c = (i % (DV / 8)) * 8, key = key0 + r;
      const bool ok = key < p.kv_len;
      cp_async16(dv_ + r * VS + c, v + (ok ? key : 0) * p.v_st + c, ok);
    }
  };

  const int tok_lo = row0 / p.group;
  const int tok_hi = (min(row0 + kRowsTc, total) - 1) / p.group;
  const Row ra = row_info(p, kvh, row0 + warp * 16 + g);
  const Row rb = row_info(p, kvh, row0 + warp * 16 + g + 8);
  const bool warp_active = row0 + warp * 16 < total;
  const bool sigmoid = kGeneral && p.sigmoid;

  float acc[kN8][4];
#pragma unroll
  for (int n = 0; n < kN8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;

  if (t0 < t1) {
    load_kv(t0, 0);
    cp_async_commit();
  }
  for (int it = t0; it < t1; ++it) {
    const int buf = (it - t0) & 1;
    if (it + 1 < t1) {  // the next tile flies while this one is computed
      load_kv(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_active) {
      const bf16* ks = sK + buf * kTileK * QS;
      const bf16* vs = sV + buf * kTileK * VS;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
      const bf16* qa = sQ + (warp * 16 + g) * QS + 2 * t;
      for (int kk = 0; kk < d; kk += 16) {
        uint32_t a[4] = {ld32(qa + kk), ld32(qa + 8 * QS + kk),
                         ld32(qa + kk + 8), ld32(qa + 8 * QS + kk + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* kb = ks + (j * 8 + g) * QS + kk + 2 * t;
          mma_bf16(s[j], a, ld32(kb), ld32(kb + 8));
        }
      }
      // S[row][key]: s[j][0..1] row g, keys j*8 + 2t, +1; s[j][2..3] row g+8
      const int key0 = it * kTileK + 2 * t;
      if (tile_full(p, it, tok_lo, tok_hi)) {  // no key masked: no tests
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[j][c] = transform<kGeneral>(p, c < 2 ? ra : rb,
                                          key0 + j * 8 + (c & 1), s[j][c]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const Row& r = c < 2 ? ra : rb;
            const int kv = key0 + j * 8 + (c & 1);
            s[j][c] = keep(p, r, kv) ? transform<kGeneral>(p, r, kv, s[j][c])
                                     : (sigmoid ? 0.f : -CUDART_INF_F);
          }
      }
      if (!sigmoid) {
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
        }
        mx_a = quad_max(mx_a);
        mx_b = quad_max(mx_b);
        const float sa = (mx_a == -CUDART_INF_F) ? 0.f : mx_a;
        const float sb = (mx_b == -CUDART_INF_F) ? 0.f : mx_b;
        const float alpha_a = (m_a == -CUDART_INF_F) ? 0.f : exp2f(m_a - sa);
        const float alpha_b = (m_b == -CUDART_INF_F) ? 0.f : exp2f(m_b - sb);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // exp2(-inf) = 0 for masked keys
          s[j][0] = exp2f(s[j][0] - sa);
          s[j][1] = exp2f(s[j][1] - sa);
          s[j][2] = exp2f(s[j][2] - sb);
          s[j][3] = exp2f(s[j][3] - sb);
          sum_a += s[j][0] + s[j][1];
          sum_b += s[j][2] + s[j][3];
        }
        // this thread's share of l; the four of a row add up at the end
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int n = 0; n < kN8; ++n) {
          acc[n][0] *= alpha_a;
          acc[n][1] *= alpha_a;
          acc[n][2] *= alpha_b;
          acc[n][3] *= alpha_b;
        }
      }
      // P.V: the S fragments of keys 16kj..16kj+15 are P's A fragment
      const int mi = lane >> 3;
      const bf16* vrow = vs + ((mi & 1) * 8 + (lane & 7)) * VS + (mi >> 1) * 8;
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        const uint32_t a[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                               pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                               pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                               pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
        for (int n = 0; n < DV / 16; ++n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + kj * 16 * VS + n * 16);
          mma_bf16(acc[2 * n], a, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (!warp_active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& r = half ? rb : ra;
    if (r.tok < 0) continue;
    float lse;
    const float f =
        finish_row(p, r, split, half ? m_b : m_a, half ? l_b : l_a, &lse);
    const size_t orow = out_row(p, r, split);
    if (p.splits == 1) {
      bf16* o = static_cast<bf16*>(p.o) + orow * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) = __floats2bfloat162_rn(
            acc[n][2 * half] * f, acc[n][2 * half + 1] * f);
    } else {
      float* o = static_cast<float*>(p.o) + orow * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * half] * f, acc[n][2 * half + 1] * f);
    }
    if (t == 0) p.lse[orow] = lse;
  }
}

// ------------------------------------------------------------- CUDA cores

size_t f32_smem_bytes(int d, int dv) {
  return (size_t(kRowsF32) * d + size_t(kTileK) * (d + 1) +
          size_t(kTileK) * dv + size_t(kRowsF32) * kTileK + 3 * kRowsF32) *
         sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 q, k, v: a CTA of 16 packed rows; QK with a thread per (key, 8
// rows), the softmax a warp per 4 rows, P.V with a thread per output column
// (two for dv > 128).
template <bool kGeneral>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  constexpr int ROWS = kRowsF32, RPT = ROWS / 2, RPW = ROWS / 4;
  extern __shared__ float smem_f[];
  const int d = p.d, dv = p.dv;
  float* q_s = smem_f;                   // [ROWS][d]
  float* k_s = q_s + ROWS * d;           // [kTileK][d + 1]
  float* v_s = k_s + kTileK * (d + 1);   // [kTileK][dv]
  float* p_s = v_s + kTileK * dv;        // [ROWS][kTileK]
  float* alpha_s = p_s + ROWS * kTileK;  // [ROWS]
  float* l_s = alpha_s + ROWS;
  float* m_s = l_s + ROWS;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = tile * ROWS, total = p.qo_len * p.group;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k) + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + kvh * p.v_sh;
  const bool sigmoid = kGeneral && p.sigmoid;

  for (int i = tid; i < ROWS * d; i += kThreads) {
    const int r = i / d, c = i % d, pr = row0 + r;
    float x = 0.f;
    if (pr < total) {
      const int tok = pr / p.group, h = kvh * p.group + pr % p.group;
      x = q[tok * p.q_st + h * p.q_sh + c];
    }
    q_s[i] = x;
  }
  const int jq = tid % kTileK, rg = tid / kTileK;
  Row rq[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) rq[r] = row_info(p, kvh, row0 + rg * RPT + r);

  float m_reg[RPW], l_reg[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_reg[r] = -CUDART_INF_F;
    l_reg[r] = 0.f;
  }
  float acc[2][ROWS];
#pragma unroll
  for (int ci = 0; ci < 2; ++ci)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[ci][r] = 0.f;

  int t0, t1;
  key_tiles(p, row0, ROWS, split, t0, t1);
  for (int it = t0; it < t1; ++it) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    const int key0 = it * kTileK;
    for (int i = tid; i < kTileK * d; i += kThreads) {
      const int j = i / d, c = i % d, key = key0 + j;
      k_s[j * (d + 1) + c] = key < p.kv_len ? k[key * p.k_st + c] : 0.f;
    }
    for (int i = tid; i < kTileK * dv; i += kThreads) {
      const int j = i / dv, c = i % dv, key = key0 + j;
      v_s[i] = key < p.kv_len ? v[key * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float s[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) s[r] = 0.f;
    const float* krow = k_s + jq * (d + 1);
    for (int c = 0; c < d; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2],
                  k3 = krow[c + 3];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (rg * RPT + r) * d + c);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }
    const int kv = key0 + jq;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      p_s[(rg * RPT + r) * kTileK + jq] =
          keep(p, rq[r], kv) ? transform<kGeneral>(p, rq[r], kv, s[r])
                             : (sigmoid ? 0.f : -CUDART_INF_F);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      if (sigmoid) {
        if (lane == 0) alpha_s[row] = 1.f;
        continue;
      }
      float* pr = p_s + row * kTileK;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_new = fmaxf(m_reg[r], warp_max(fmaxf(x0, x1)));
      const float m_safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float e0 = exp2f(x0 - m_safe), e1 = exp2f(x1 - m_safe);
      const float alpha =
          (m_reg[r] == -CUDART_INF_F) ? 0.f : exp2f(m_reg[r] - m_safe);
      l_reg[r] = l_reg[r] * alpha + warp_sum(e0 + e1);
      m_reg[r] = m_new;
      pr[lane] = e0;
      pr[lane + 32] = e1;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int col = tid + ci * kThreads;
      if (col >= dv) continue;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[ci][r] *= alpha_s[r];
      for (int j = 0; j < kTileK; j += 4) {
        const float v0 = v_s[j * dv + col], v1 = v_s[(j + 1) * dv + col];
        const float v2 = v_s[(j + 2) * dv + col], v3 = v_s[(j + 3) * dv + col];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 pv =
              *reinterpret_cast<const float4*>(p_s + r * kTileK + j);
          acc[ci][r] = fmaf(pv.x, v0, acc[ci][r]);
          acc[ci][r] = fmaf(pv.y, v1, acc[ci][r]);
          acc[ci][r] = fmaf(pv.z, v2, acc[ci][r]);
          acc[ci][r] = fmaf(pv.w, v3, acc[ci][r]);
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
  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const Row row = row_info(p, kvh, row0 + r);
    if (row.tok < 0) continue;
    float lse;
    const float f = finish_row(p, row, split, m_s[r], l_s[r], &lse);
    const size_t orow = out_row(p, row, split);
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int col = tid + ci * kThreads;
      if (col < dv) o[orow * dv + col] = acc[ci][r] * f;
    }
    if (tid == 0) p.lse[orow] = lse;
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int rows, size_t bytes,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((p.qo_len * p.group + rows - 1) / rows, p.hkv, p.splits);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <bool G>
cudaError_t launch_tc(const Params& p, cudaStream_t s) {
  const size_t bytes = tc_smem_bytes(p.d, p.dv);
  switch (p.dv) {
    case 64: return launch(flash_tc_kernel<64, G>, p, kRowsTc, bytes, s);
    case 128: return launch(flash_tc_kernel<128, G>, p, kRowsTc, bytes, s);
    case 192: return launch(flash_tc_kernel<192, G>, p, kRowsTc, bytes, s);
    case 256: return launch(flash_tc_kernel<256, G>, p, kRowsTc, bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fi_flash_attention(
    const void* q, const void* k, const void* v, const uint8_t* mask,
    const float* alibi, const float* sink, void* o, float* lse,
    long long q_st, long long q_sh, long long k_st, long long k_sh,
    long long v_st, long long v_sh, int qo_len, int kv_len, int hq, int hkv,
    int d, int dv, int causal, int window_left, int splits, float sm_scale,
    float soft_cap, int sigmoid, float sig_scale, float sig_bias, int dtype,
    void* stream) {
  if (qo_len <= 0 || kv_len < 0 || hkv <= 0 || hq % hkv != 0 || d % 16 != 0 ||
      d <= 0 || d > 256 || dv % 16 != 0 || dv <= 0 || dv > 256 || splits < 1)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.mask = mask; p.alibi = alibi; p.sink = sink;
  p.o = o; p.lse = lse;
  p.q_st = q_st; p.q_sh = q_sh; p.k_st = k_st; p.k_sh = k_sh;
  p.v_st = v_st; p.v_sh = v_sh;
  p.qo_len = qo_len; p.kv_len = kv_len; p.hq = hq; p.hkv = hkv;
  p.group = hq / hkv; p.d = d; p.dv = dv;
  p.causal = causal; p.window_left = window_left; p.splits = splits;
  p.sigmoid = sigmoid;
  p.sm_scale = sm_scale;
  p.scale_log2 = float(double(sm_scale) * 1.4426950408889634);
  p.soft_cap = soft_cap; p.sig_scale = sig_scale; p.sig_bias = sig_bias;
  const bool general = alibi != nullptr || soft_cap > 0.f || sigmoid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16) {
    err = general ? launch_tc<true>(p, s) : launch_tc<false>(p, s);
  } else if (dtype == kF32) {
    const size_t bytes = f32_smem_bytes(d, dv);
    err = general ? launch(flash_f32_kernel<true>, p, kRowsF32, bytes, s)
                  : launch(flash_f32_kernel<false>, p, kRowsF32, bytes, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}
