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
// Outputs: o [qo_len, hq, dv] in q's dtype and lse [qo_len, hq]. With S > 1
// splits of the key range, the attention kernel writes f32 partial states
// o [qo_len, S, hq, dv] and lse [qo_len, S, hq] into the caller's scratch
// and a merge kernel, launched by the same entry point, combines them (the
// sink joins split 0's state, so the merge adds it once).
//
// What bounds it on the H100: at prefill the operations (4 * d flops a
// (query, key) pair; Llama-3-8B's 8192-token causal prefill is 0.55 TFLOP,
// 0.56 ms at 989 TFLOP/s against 0.05 ms of bytes), at decode the K/V
// bytes (one query token sees the whole cache: 134 MB at 32K tokens).
// Design (bf16), FA3-shaped for Hopper:
// - wgmma for both products. A CTA holds two consumer warpgroups of 64
//   GQA-packed query rows each (row = token * group + head in group), so it
//   serves 128 packed rows of one kv head and each K/V tile serves the head
//   group. S = Q.K^T is wgmma m64nTk16 with Q and K in shared memory in the
//   128-byte swizzle layout (64-element column blocks); S's accumulator
//   layout is P's A fragment, so O += P.V is the register-A form with V
//   MN-major (tnspB), and P never leaves registers.
// - TMA for K and V: one 3-D tensor map each over the caller's strides
//   (NHD and HND alike), zero fill past kv_len, passed as
//   __grid_constant__ parameters (a CUDA graph records them by value).
// - Warp specialisation: a producer warpgroup (24 registers; one thread)
//   keeps a ring of two K/V stages full behind full/empty mbarriers; the
//   consumers take 240 registers (setmaxnreg). Tiles of 128 keys, 64 where
//   S (64 x 128) beside O (64 x dv) or the stages do not fit (dv > 128,
//   d 256 with dv 128).
// - The two consumers run independently (S, softmax, P.V a tile each), so
//   the warp schedulers overlap one's softmax with the other's wgmma. FA3's
//   ping-pong (turns taken at named barriers) measured 1.3x slower on the
//   H100 at Llama's prefill, and a warpgroup issuing a tile's S beside the
//   previous tile's P.V 1.2x slower (ptxas serialised the wgmma: the
//   softmax writes S's registers while P.V is in flight), so neither is
//   used (PERF.md).
// - The softmax is short: the variant's branch is taken once a tile, not an
//   element; 2^x is one MUFU op (ex2.approx.ftz); the default path folds
//   its scale into the exponent's FMA after the row max, so it needs a
//   positive scale (any other takes the general path).
// - The key loop runs from the window's first needed tile to the causal
//   frontier of the CTA's last token; only the tiles at the edges (the
//   diagonal, the window's start, the end of the KV, a custom mask) test
//   each (row, key); the CTAs with the most keys start first.
// - A mask's structure reaches the key loop through a tile map, uint8
//   [map heads, 64-row blocks of packed rows, 64-key tiles], written by a
//   first launch (fi_flash_tile_map: the packed bits, the caller's mask
//   hook, or both, asked of every (row, key) that kv_len, causal and the
//   window allow; once per kv head where the hook reads the head, else
//   once for all, a row block's tokens at their first head): bit kMapKeep
//   where a real row keeps such a key, kMapDrop where the mask drops one.
//   A second launch lists, for each CTA, the tiles a row block of it keeps
//   a key of, with their classes (flash_walk_kernel, csrc/tile_walk.cuh);
//   the CTA's producer and consumers walk that list, skipping the other
//   tiles (each would add nothing: the rescale 2^0, every P 0, the
//   sigmoid's weights 0); a tile the mask keeps whole takes the
//   mask-free path (tile_full, or keep() without the mask); only the tiles
//   it cuts test the mask. Without a map every tile under a mask is tested
//   key by key.
// - When the (row tile, kv head) CTAs would leave most SMs idle (decode),
//   the key range is split across CTAs (the wrapper picks the count) and a
//   second launch of this entry point merges the splits: no PyTorch op and
//   no allocation of its own.
// f32 runs on the CUDA cores in f32 (16 rows a CTA), so f32 keeps f32
// accuracy.
//
// A caller's variant (flashinfer_tpu_torch/jit/variant.py) arrives as a
// generated header, passed by -include with -DFI_USER_VARIANT: its hooks
// user_logits, user_mask, user_q and user_out (scalar functions), their
// flags FI_USER_HAS_* and FI_USER_SOFTMAX, and the UserParams its leaves
// travel in. Such a build runs the elementwise path with the hooks in
// place of the built-in transform: the logits hook on s * sm_scale (then
// log2(e) under softmax; without softmax its value is the weight), the
// mask ANDed into keep() (so every tile tests each key), the q hook on
// each q element in f32 (rounded to q's dtype before the product), the
// output hook on f32 o before the store (in the split merge's store when
// the keys are split). Without the macro nothing here changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile_walk.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWgRows = 64;                 // packed rows a consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups a CTA
constexpr int kRowsTc = kWgRows * kConsumers;
constexpr int kTcThreads = 128 * (kConsumers + 1);  // + the producer
constexpr int kStages = 2;                  // K/V stages in shared memory
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kThreads = 128;               // CUDA-core kernel
constexpr int kTileF32 = 64;                // keys a tile, CUDA-core kernel
constexpr int kRowsF32 = 16;                // packed rows a CTA, CUDA cores
constexpr int kSmemLimit = 232448;          // bytes a CTA may use (H100)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
#if defined(FI_USER_VARIANT) && FI_USER_HAS_MASK
#define FI_USER_MASK 1
#else
#define FI_USER_MASK 0
#endif

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;          // [qo_len, hq, d] through q_st / q_sh
  const void* k;          // [kv_len, hkv, d] through k_st / k_sh
  const void* v;          // [kv_len, hkv, dv] through v_st / v_sh
  const uint8_t* mask;    // packed bits or null
  const uint8_t* tile_map;  // [map_heads, map_rb, map_nt] or null
  const float* alibi;     // [hq] or null
  const float* sink;      // [hq] or null; applied by split 0
  void* o;
  float* lse;
  long long q_st, q_sh, k_st, k_sh, v_st, v_sh;  // strides in elements
  int qo_len, kv_len, hq, hkv, group, d, dv;
  int causal, window_left, splits, sigmoid;
  float sm_scale, scale_log2, soft_cap, sig_scale, sig_bias;
  int heads_inner;  // the K/V tensor maps order (d, head, token)
  int map_heads, map_rb, map_nt;  // the tile map's kv heads (1 or hkv),
                                  // 64-row blocks and 64-key tiles
  // the walks (with a map): [walks] counts, then [walks][map_nt] lists, a
  // walk a (q tile, map head, split)
  int* walk_ws;
  size_t walk_ws_len;  // ints
  int walks;
#ifdef FI_USER_VARIANT
  UserParams user;
#endif
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

// Whether row r may see key kv at all: a real row, a real key, causal, the
// window.
__device__ __forceinline__ bool in_reach(const Params& p, const Row& r,
                                         int kv) {
  return r.tok >= 0 && kv < p.kv_len && !(p.causal && kv > r.q_pos) &&
         !(p.window_left >= 0 && kv < r.q_pos - p.window_left);
}

// Whether the mask (the packed bits, the caller's hook) keeps (r, kv).
__device__ __forceinline__ bool mask_keeps(const Params& p, const Row& r,
                                           int kv) {
  if (p.mask) {
    const long long bit = (long long)r.tok * p.kv_len + kv;
    if (!((p.mask[bit >> 3] >> (7 - int(bit & 7))) & 1)) return false;
  }
#if FI_USER_MASK
  if (!user_mask(r.q_pos, kv, r.head, p.user)) return false;
#endif
  return true;
}

// Whether row r sees key kv (the mask included). Written out, not as
// in_reach && mask_keeps: that form ran the packed random-bit mask ~10%
// slower on the H100.
__device__ __forceinline__ bool keep(const Params& p, const Row& r, int kv) {
  if (r.tok < 0 || kv >= p.kv_len) return false;
  if (p.causal && kv > r.q_pos) return false;
  if (p.window_left >= 0 && kv < r.q_pos - p.window_left) return false;
  if (p.mask) {
    const long long bit = (long long)r.tok * p.kv_len + kv;
    if (!((p.mask[bit >> 3] >> (7 - int(bit & 7))) & 1)) return false;
  }
#if FI_USER_MASK
  if (!user_mask(r.q_pos, kv, r.head, p.user)) return false;
#endif
  return true;
}

// The map's bits for row block rb of kv head kvh over key tile t of TK keys
// (ORed over its 64-key tiles).
template <int TK>
__device__ __forceinline__ int map_class(const Params& p, int kvh, int rb,
                                         int t) {
  const uint8_t* m =
      p.tile_map +
      (size_t(p.map_heads > 1 ? kvh : 0) * p.map_rb + rb) * p.map_nt;
  int c = 0;
#pragma unroll
  for (int s = 0; s < TK / kMapKeys; ++s) {
    const int j = t * (TK / kMapKeys) + s;
    if (j < p.map_nt) c |= m[j];
  }
  return c;
}

// The variant's transform of a logit, one of: the default (log2(e) *
// sm_scale folded in), the sigmoid, ALiBi alone, ALiBi and the soft cap.
enum Kind { kPlain, kSigmoid, kBias, kCapped };

// A kept logit as the softmax takes it (base 2), or the sigmoid's weight;
// alibi is ALiBi's slope * (kv_pos - q_pos) (0 without ALiBi).
template <int K>
__device__ __forceinline__ float transform_k(const Params& p, float alibi,
                                             float s) {
  if (K == kPlain) return s * p.scale_log2;
  float x = s * p.sm_scale;
  if (K == kSigmoid) return 1.f / (1.f + expf(-(x * p.sig_scale + p.sig_bias)));
  x += alibi;
  if (K == kCapped) x = p.soft_cap * tanhf(x / p.soft_cap);
  return x * kLog2e;
}

#ifdef FI_USER_VARIANT
// The caller's variant on a logit of row r at key kv: its hook on s *
// sm_scale (keys past the end take the last key's position: their values
// are masked), then log2(e) under softmax.
__device__ __forceinline__ float user_transform(const Params& p, const Row& r,
                                                int kv, float s) {
  float x = __fmul_rn(s, p.sm_scale);
#if FI_USER_HAS_LOGITS
  x = user_logits(x, r.q_pos, min(kv, p.kv_len - 1), r.head, p.user);
#endif
  return FI_USER_SOFTMAX ? __fmul_rn(x, kLog2e) : x;
}

// user_transform over a tile of S accumulators (laid out as
// transform_tile's).
template <int N>
__device__ __forceinline__ void user_transform_tile(const Params& p, float* s,
                                                    const Row& ra,
                                                    const Row& rb, int key0) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i] = user_transform(p, (i & 2) ? rb : ra, key0 + (i >> 2) * 8 + (i & 1),
                          s[i]);
}

// The q hook on eight bf16 q values of `head`, in f32, rounded back.
__device__ __forceinline__ uint4 user_q_bf16x8(uint4 x, int head,
                                               const UserParams& u) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v[j]);
    v[j] = __floats2bfloat162_rn(user_q(f.x, head, u), user_q(f.y, head, u));
  }
  return x;
}
#endif

template <bool kGeneral>
__device__ __forceinline__ float transform(const Params& p, float alibi,
                                           float s) {
  if (!kGeneral) return transform_k<kPlain>(p, alibi, s);
  if (p.sigmoid) return transform_k<kSigmoid>(p, alibi, s);
  return p.soft_cap > 0.f ? transform_k<kCapped>(p, alibi, s)
                          : transform_k<kBias>(p, alibi, s);
}

// The key tiles [t0, t1) of kTile keys that rows [row0, row0 + rows) of
// this split need.
template <int kTile>
__device__ __forceinline__ void key_tiles(const Params& p, int row0, int rows,
                                          int split, int& t0, int& t1) {
  const int last = min(row0 + rows, p.qo_len * p.group) - 1;
  const int off = p.kv_len - p.qo_len;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, off + last / p.group + 1);
  int kv_begin = 0;
  if (p.window_left >= 0)
    kv_begin = max(0, off + row0 / p.group - p.window_left);
  t0 = kv_begin / kTile;
  t1 = kv_end > kv_begin ? (kv_end + kTile - 1) / kTile : t0;
  if (p.splits > 1) {
    const int per = (t1 - t0 + p.splits - 1) / p.splits;
    const int s0 = t0 + split * per;
    t1 = min(t1, s0 + per);  // t1 <= t0: an empty split
    t0 = s0;
  }
}

// transform_k<K> over a tile of S accumulators: s[4j + c] is row ra (c <
// 2) or rb at key key0 + 8j + (c & 1). ALiBi's bias is taken at the first
// key a row and moved by the slope times a constant (no int-to-float
// conversion an element).
template <int K, int N>
__device__ __forceinline__ void transform_tile(const Params& p, float* s,
                                               const Row& ra, const Row& rb,
                                               int key0) {
  const float ba = ra.slope * float(key0 - ra.q_pos);
  const float bb = rb.slope * float(key0 - rb.q_pos);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Row& r = (i & 2) ? rb : ra;
    const float alibi =
        fmaf(r.slope, float((i >> 2) * 8 + (i & 1)), (i & 2) ? bb : ba);
    s[i] = transform_k<K>(p, alibi, s[i]);
  }
}

// Whether every (row, key) of key tile kt is kept for the real rows
// (tokens tok_lo..tok_hi), the mask aside (`masked` false: the tile map
// says it keeps the tile whole); rows past the end compute values nobody
// stores.
template <int kTile>
__device__ __forceinline__ bool tile_full(const Params& p, int kt, int tok_lo,
                                          int tok_hi, bool masked) {
  const int k_lo = kt * kTile, k_hi = k_lo + kTile - 1;
  const int off = p.kv_len - p.qo_len;
  return !masked && k_hi < p.kv_len && !(p.causal && k_hi > off + tok_lo) &&
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

// 2^x on the MUFU alone (exp2f adds a rescale for subnormal results): a
// weight below 2^-126 of the row's largest moves neither l nor o.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory: Q [consumers][d blocks][64 rows][128 B], then kStages
// stages of K [d blocks][tile][128 B] and V [dv blocks][tile][128 B], then
// the stages' barriers; 1024 bytes of slack to align the swizzle atoms.
size_t tc_smem_bytes(int d, int dv, int tile) {
  const int db = (d + 63) / 64, vb = dv / 64;
  return 1024 + size_t(kConsumers) * db * kWgRows * 128 +
         kStages * (size_t(db) + vb) * tile * 128 + 4 * kStages * 8;
}

// Keys a tile for (d, dv): 128 where S (64 x 128) and O (64 x dv) fit the
// registers and the stages fit the shared memory, else 64 (the wrapper's
// _tile_k mirrors this).
int tc_tile_k(int d, int dv) {
  return dv <= 128 && tc_smem_bytes(d, dv, 128) <= kSmemLimit ? 128 : 64;
}

template <int DV, int TK, bool kGeneral>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kS = TK / 2;    // S accumulators a thread
  constexpr int kO = DV / 2;    // O accumulators a thread
  constexpr int kVB = DV / 64;  // V column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int d = p.d, qb = (d + 63) / 64;
  const int k_stage = qb * TK * 128, v_stage = kVB * TK * 128;
  unsigned char* sQ = base;                                 // per consumer
  unsigned char* sK = sQ + kConsumers * qb * kWgRows * 128;  // stages
  unsigned char* sV = sK + kStages * k_stage;                // stages
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sV + kStages * v_stage);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int tile = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int row0 = tile * kRowsTc, total = p.qo_len * p.group;
  // consumer warpgroups with real rows: each releases every stage
  const int active = row0 + kWgRows < total ? 2 : 1;
  int t0, t1;
  key_tiles<TK>(p, row0, kRowsTc, split, t0, t1);
  // a tile's classes without a map: a mask cuts every tile
  const int mask_cls =
      (p.mask || FI_USER_MASK) ? kMapKeep | kMapDrop : kMapKeep;
  __shared__ int s_walk;  // tiles the CTA walks
  // its walk's index: (q tile, map head, split)
  const int widx =
      (tile * p.map_heads + (p.map_heads > 1 ? kvh : 0)) * p.splits + split;

  if (tid == 0) {
    s_walk = p.walk_ws ? p.walk_ws[widx] : (t1 > t0 ? t1 - t0 : 0);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], 4 * active);  // one arrival a consumer warp
      mbar_init(&empty_v[i], 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk walk{p.walk_ws ? reinterpret_cast<const uint32_t*>(
                                 p.walk_ws + p.walks) +
                                 size_t(widx) * p.map_nt
                           : nullptr,
                  t0, s_walk, mask_cls | mask_cls << 2};

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the K/V ring full through TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (wtid == 0) {
      int next = walk.n > 0 ? walk.tile(0) : 0;  // a list's entry ahead
      for (int i = 0; i < walk.n; ++i) {
        const int it = next, st = i % kStages;
        const int ph = (i / kStages) & 1;
        if (i + 1 < walk.n) next = walk.tile(i + 1);
        const int key0 = it * TK;
        const int c1 = p.heads_inner ? kvh : key0;
        const int c2 = p.heads_inner ? key0 : kvh;
        mbar_wait(&empty_k[st], ph ^ 1);
        mbar_expect_tx(&full_k[st], k_stage);
        for (int cb = 0; cb < qb; ++cb)
          tma_load3(sK + st * k_stage + cb * TK * 128, &tm_k, &full_k[st],
                    cb * 64, c1, c2);
        mbar_wait(&empty_v[st], ph ^ 1);
        mbar_expect_tx(&full_v[st], v_stage);
#pragma unroll
        for (int cb = 0; cb < kVB; ++cb)
          tma_load3(sV + st * v_stage + cb * TK * 128, &tm_v, &full_v[st],
                    cb * 64, c1, c2);
      }
    }
  } else {
    // ---- consumers: 64 packed rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (wg >= active) return;
    const int lane = tid & 31, warp = wtid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wrow0 = row0 + wg * kWgRows;  // this warpgroup's first row
    const bf16* q = static_cast<const bf16*>(p.q);

    // Q: zero past the rows and past d
    unsigned char* sQw = sQ + wg * qb * kWgRows * 128;
    for (int i = wtid; i < kWgRows * qb * 8; i += 128) {
      const int r = i / (qb * 8), cb = (i / 8) % qb, c = i % 8;
      const int pr = wrow0 + r, col = cb * 64 + c * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (pr < total && col < d) {
        const int tok = pr / p.group, h = kvh * p.group + pr % p.group;
        x = *reinterpret_cast<const uint4*>(q + tok * p.q_st + h * p.q_sh +
                                            col);
#if defined(FI_USER_VARIANT) && FI_USER_HAS_Q
        x = user_q_bf16x8(x, h, p.user);
#endif
      }
      *reinterpret_cast<uint4*>(sQw + cb * kWgRows * 128 + sw128(r, c)) = x;
    }
    fence_async_smem();  // Q is visible to this warpgroup's wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int tok_lo = wrow0 / p.group;
    const int tok_hi = (min(wrow0 + kWgRows, total) - 1) / p.group;
    const Row ra = row_info(p, kvh, wrow0 + warp * 16 + g);
    const Row rb = row_info(p, kvh, wrow0 + warp * 16 + g + 8);
    const bool sigmoid = kGeneral && p.sigmoid;

    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;

    for (int i = 0; i < walk.n; ++i) {
      const int it = walk.tile(i), st = i % kStages;
      const int ph = (i / kStages) & 1;
      const unsigned char* ks = sK + st * k_stage;
      const unsigned char* vs = sV + st * v_stage;
      float s[kS];
      mbar_wait(&full_k[st], ph);
      wg_fence();
      for (int kk = 0; kk < d / 16; ++kk) {
        const int off = (kk >> 2) * kWgRows * 128 + (kk & 3) * 32;
        const int koff = (kk >> 2) * TK * 128 + (kk & 3) * 32;
        wgmma_ss<TK>(s, sw128_desc(sQw + off, 16, 1024),
                     sw128_desc(ks + koff, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      hold<kS>(s);
      if (lane == 0) mbar_arrive(&empty_k[st]);
      // s[4j + c]: row g (c < 2) or g + 8, key 8j + 2t + (c & 1)
      const int key0 = it * TK + 2 * t;
      // The variant's transform, its branch taken once a tile. The default
      // leaves the logits raw: its scale (> 0) joins the exponent below.
      if (kGeneral) {
#ifdef FI_USER_VARIANT
        user_transform_tile<kS>(p, s, ra, rb, key0);
#else
        if (p.sigmoid)
          transform_tile<kSigmoid, kS>(p, s, ra, rb, key0);
        else if (p.soft_cap > 0.f)
          transform_tile<kCapped, kS>(p, s, ra, rb, key0);
        else
          transform_tile<kBias, kS>(p, s, ra, rb, key0);
#endif
      }
      // whether the mask cuts this warpgroup's rows of the tile
      const bool masked = walk.classes(i) >> (2 * wg) & kMapDrop;
      if (!tile_full<TK>(p, it, tok_lo, tok_hi, masked)) {  // an edge
        if (masked) {  // the mask cuts it: each key asked
#pragma unroll
          for (int i = 0; i < kS; ++i)
            if (!keep(p, (i & 2) ? rb : ra, key0 + (i >> 2) * 8 + (i & 1)))
              s[i] = sigmoid ? 0.f : -CUDART_INF_F;
        } else {
#pragma unroll
          for (int i = 0; i < kS; ++i)
            if (!in_reach(p, (i & 2) ? rb : ra,
                          key0 + (i >> 2) * 8 + (i & 1)))
              s[i] = sigmoid ? 0.f : -CUDART_INF_F;
        }
      }
      if (!sigmoid) {
        const float c = kGeneral ? 1.f : p.scale_log2;  // raw logit -> base 2
        float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < kS; i += 4) {
          mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
        }
        mx_a = fmaxf(m_a, quad_max(mx_a) * c);
        mx_b = fmaxf(m_b, quad_max(mx_b) * c);
        const float sa = (mx_a == -CUDART_INF_F) ? 0.f : mx_a;
        const float sb = (mx_b == -CUDART_INF_F) ? 0.f : mx_b;
        const float alpha_a = (m_a == -CUDART_INF_F) ? 0.f : exp2_ftz(m_a - sa);
        const float alpha_b = (m_b == -CUDART_INF_F) ? 0.f : exp2_ftz(m_b - sb);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < kS; i += 4) {  // exp2(-inf) = 0 for masked keys
          s[i] = exp2_ftz(fmaf(s[i], c, -sa));
          s[i + 1] = exp2_ftz(fmaf(s[i + 1], c, -sa));
          s[i + 2] = exp2_ftz(fmaf(s[i + 2], c, -sb));
          s[i + 3] = exp2_ftz(fmaf(s[i + 3], c, -sb));
          sum_a += s[i] + s[i + 1];
          sum_b += s[i + 2] + s[i + 3];
        }
        // this thread's share of l; the four of a row add up at the end
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int i = 0; i < kO; i += 4) {
          o[i] *= alpha_a;
          o[i + 1] *= alpha_a;
          o[i + 2] *= alpha_b;
          o[i + 3] *= alpha_b;
        }
      }
      // P.V: S's accumulators of keys 16kk..16kk+15 are P's A fragment
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(&full_v[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<DV>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, TK * 128, 1024),
                     1);
      wg_commit();
      wg_wait<0>();
      hold<kO>(o);
      hold<TK / 4>(&pa[0][0]);
      if (lane == 0) mbar_arrive(&empty_v[st]);
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Row& r = half ? rb : ra;
      if (r.tok < 0) continue;
      float lse;
      const float f =
          finish_row(p, r, split, half ? m_b : m_a, half ? l_b : l_a, &lse);
      const size_t orow = out_row(p, r, split);
      if (p.splits == 1) {
        bf16* out = static_cast<bf16*>(p.o) + orow * DV + 2 * t;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
#if defined(FI_USER_VARIANT) && FI_USER_HAS_OUT
          *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
              __floats2bfloat162_rn(
                  user_out(o[4 * j + 2 * half] * f, r.head, p.user),
                  user_out(o[4 * j + 2 * half + 1] * f, r.head, p.user));
#else
          *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
              __floats2bfloat162_rn(o[4 * j + 2 * half] * f,
                                    o[4 * j + 2 * half + 1] * f);
#endif
      } else {
        float* out = static_cast<float*>(p.o) + orow * DV + 2 * t;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(out + j * 8) = make_float2(
              o[4 * j + 2 * half] * f, o[4 * j + 2 * half + 1] * f);
      }
      if (t == 0) p.lse[orow] = lse;
    }
  }
}

// ------------------------------------------------------------- CUDA cores

size_t f32_smem_bytes(int d, int dv) {
  return (size_t(kRowsF32) * d + size_t(kTileF32) * (d + 1) +
          size_t(kTileF32) * dv + size_t(kRowsF32) * kTileF32 + 3 * kRowsF32) *
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
  constexpr int kTileK = kTileF32;
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
#if defined(FI_USER_VARIANT) && FI_USER_HAS_Q
      x = user_q(x, h, p.user);
#endif
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
  key_tiles<kTileK>(p, row0, ROWS, split, t0, t1);
  const int mask_cls = (p.mask || FI_USER_MASK) ? kMapKeep | kMapDrop
                                                : kMapKeep;
  for (int it = t0; it < t1; ++it) {
    // the tile map's class of the tile (its 64 keys are one tile of the
    // map): skipped where the mask keeps no key, unread where it keeps all
    const int c = p.tile_map ? map_class<kTileK>(p, kvh, row0 / kMapRows, it)
                             : mask_cls;
    if (!(c & kMapKeep)) continue;
    const bool masked = c & kMapDrop;
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
          (masked ? keep(p, rq[r], kv) : in_reach(p, rq[r], kv))
#ifdef FI_USER_VARIANT
              ? user_transform(p, rq[r], kv, s[r])
#else
              ? transform<kGeneral>(
                    p, rq[r].slope * float(kv - rq[r].q_pos), s[r])
#endif
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
#if defined(FI_USER_VARIANT) && FI_USER_HAS_OUT
      if (col < dv)
        o[orow * dv + col] = p.splits == 1
                                 ? user_out(acc[ci][r] * f, row.head, p.user)
                                 : acc[ci][r] * f;
#else
      if (col < dv) o[orow * dv + col] = acc[ci][r] * f;
#endif
    }
    if (tid == 0) p.lse[orow] = lse;
  }
}

// ------------------------------------------------------------- tile map

constexpr int kMapWarps = 8;  // key tiles a CTA of the map kernel

// The tile map of a mask (the packed bits, the caller's hook, or both): a
// warp per (64-key tile, 64-row block, map head), its lanes on the tile's
// keys. The rows are the block's packed rows of kv head blockIdx.z where
// the map has a head each, else the block's tokens at their first head
// (the hook does not read the head). Each (row, key) that in_reach allows
// is asked of the mask: kMapKeep where one is kept, kMapDrop where one is
// dropped. A lane asks kMapUnroll rows at a time, every ask made (its key
// clamped to a real one, its answer dropped out of reach), so their loads
// are in flight together; the warp stops once it has seen both bits.
constexpr int kMapUnroll = 8;

__global__ void __launch_bounds__(32 * kMapWarps)
    flash_map_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = blockIdx.x * kMapWarps + warp, rb = blockIdx.y;
  const int kvh = blockIdx.z;
  if (kt >= p.map_nt) return;
  const int total = p.qo_len * p.group, off = p.kv_len - p.qo_len;
  const int r0 = rb * kMapRows, r1 = min(r0 + kMapRows, total);
  const int k0 = kt * kMapKeys, k1 = min(k0 + kMapKeys, p.kv_len);
  const int tok0 = r0 / p.group, tok1 = (r1 - 1) / p.group;
  const bool per_tok = p.map_heads == 1;
  // a tile that causal or the window leaves out holds nothing
  const bool reach =
      !(p.causal && k0 > off + tok1) &&
      !(p.window_left >= 0 && k1 - 1 < off + tok0 - p.window_left);
  bool kept = false, dropped = false;
  const int rows = reach ? (per_tok ? tok1 - tok0 + 1 : r1 - r0) : 0;
  for (int j0 = 0; j0 < rows; j0 += kMapUnroll) {
#pragma unroll
    for (int jj = 0; jj < kMapUnroll; ++jj) {
      const int j = min(j0 + jj, rows - 1);  // a row asked twice: no matter
      const Row r = per_tok ? row_info(p, 0, (tok0 + j) * p.group)
                            : row_info(p, kvh, r0 + j);
#pragma unroll
      for (int e = 0; e < kMapKeys / 32; ++e) {
        const int kv = k0 + lane + 32 * e;
        const bool in = kv < k1 && in_reach(p, r, kv);
        const bool keeps = mask_keeps(p, r, min(kv, k1 - 1));
        kept |= in && keeps;
        dropped |= in && !keeps;
      }
    }
    if (__any_sync(0xffffffffu, kept) && __any_sync(0xffffffffu, dropped))
      break;
  }
  kept = __any_sync(0xffffffffu, kept);
  dropped = __any_sync(0xffffffffu, dropped);
  if (lane == 0)  // this launch writes the map the attention reads
    const_cast<uint8_t*>(p.tile_map)[(size_t(kvh) * p.map_rb + rb) *
                                         p.map_nt + kt] =
        (kept ? kMapKeep : 0) | (dropped ? kMapDrop : 0);
}

// --------------------------------------------------------------- merge

// Merges the S split states of one (token, head) a CTA: o [qo_len, S, hq,
// dv] f32 with natural-log lse [qo_len, S, hq] (-inf for a split with no
// key, the identity) into o_out [qo_len, hq, dv] and lse_out; the sigmoid's
// partial sums simply add (lse 0). Split 0's state already holds the sink.
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    merge_splits_kernel(const float* o, const float* lse, OutT* o_out,
                        float* lse_out, int splits, int hq, int dv,
                        int sigmoid
#ifdef FI_USER_VARIANT
                        , const UserParams user
#endif
                        ) {
  const int row = blockIdx.x, tok = row / hq, h = row % hq;
  const float* ls = lse + size_t(tok) * splits * hq + h;  // stride hq
  float m = -CUDART_INF_F;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, ls[i * hq]);
  const float m_safe = (m == -CUDART_INF_F) ? 0.f : m;
  float den = 0.f;
  for (int i = 0; i < splits; ++i)
    den += ls[i * hq] == -CUDART_INF_F ? 0.f : expf(ls[i * hq] - m_safe);
  const float inv = sigmoid ? 1.f : (den > 0.f ? 1.f / den : 0.f);
  const float* os = o + (size_t(tok) * splits * hq + h) * dv;
  for (int c = threadIdx.x; c < dv; c += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float w = sigmoid ? 1.f
                              : (ls[i * hq] == -CUDART_INF_F
                                     ? 0.f
                                     : expf(ls[i * hq] - m_safe));
      acc += w * os[size_t(i) * hq * dv + c];
    }
#if defined(FI_USER_VARIANT) && FI_USER_HAS_OUT
    store(o_out + size_t(row) * dv + c, user_out(acc * inv, h, user));
#else
    store(o_out + size_t(row) * dv + c, acc * inv);
#endif
  }
  if (threadIdx.x == 0)
    lse_out[row] = sigmoid ? 0.f
                           : (den > 0.f ? m_safe + logf(den) : -CUDART_INF_F);
}

// ---------------------------------------------------------------- launch

// The walks of a tile map (before the attention launch): a warp a (q tile
// of 128 packed rows, map head, split), listing in order the tiles of TK
// keys of the split's range that a row block of the tile keeps a key of.
template <int TK>
__global__ void __launch_bounds__(128) flash_walk_kernel(const Params p) {
  const int widx = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (widx >= p.walks) return;
  const int split = widx % p.splits, hm = (widx / p.splits) % p.map_heads;
  const int row0 = widx / (p.splits * p.map_heads) * kRowsTc;
  const int rb0 = row0 / kMapRows;
  int t0, t1;
  key_tiles<TK>(p, row0, kRowsTc, split, t0, t1);
  list_tiles(
      [&](int t) {
        return map_class<TK>(p, hm, rb0, t) |
               (rb0 + 1 < p.map_rb ? map_class<TK>(p, hm, rb0 + 1, t) << 2
                                   : 0);
      },
      t0, t1,
      reinterpret_cast<uint32_t*>(p.walk_ws + p.walks) +
          size_t(widx) * p.map_nt,
      p.walk_ws + widx, lane);
}

// The tile map's extents: 64-row blocks of packed rows, 64-key tiles.
void set_map_dims(Params& p, const uint8_t* tile_map, int map_heads) {
  p.tile_map = tile_map;
  p.map_heads = map_heads;
  p.map_rb = (p.qo_len * p.group + kMapRows - 1) / kMapRows;
  p.map_nt = (p.kv_len + kMapKeys - 1) / kMapKeys;
}

template <bool G>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  const size_t bytes = f32_smem_bytes(p.d, p.dv);
  auto kernel = flash_f32_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((p.qo_len * p.group + kRowsF32 - 1) / kRowsF32, p.hkv, p.splits);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

// A 3-D bf16 map over [tokens, heads, width] with the caller's strides
// (elements), boxes of 64 columns x tile tokens x 1 head, 128-byte swizzle;
// reads past the tokens or the width fill zeros. Its dims go (width, head,
// token) when heads lie closer than tokens (heads_inner), else (width,
// token, head).
bool tensor_map(CUtensorMap* map, const void* ptr, int width, int tokens,
                int heads, long long st, long long sh, int tile,
                int* heads_inner) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t tok_n = tokens > 0 ? tokens : 1, tok_b = cuuint64_t(st) * 2;
  cuuint64_t head_b = cuuint64_t(sh) * 2;
  if (heads == 1) head_b = tok_b * tok_n;  // any valid stride
  *heads_inner = head_b < tok_b;
  const cuuint64_t dims[3] = {cuuint64_t(width), *heads_inner ? heads : tok_n,
                              *heads_inner ? tok_n : cuuint64_t(heads)};
  const cuuint64_t strides[2] = {*heads_inner ? head_b : tok_b,
                                 *heads_inner ? tok_b : head_b};
  const cuuint32_t box[3] = {64, *heads_inner ? 1u : cuuint32_t(tile),
                             *heads_inner ? cuuint32_t(tile) : 1u};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DV, int TK, bool G>
cudaError_t launch_tc_at(Params p, cudaStream_t s) {
  CUtensorMap tm_k, tm_v;
  int k_inner, v_inner;
  if (!tensor_map(&tm_k, p.k, p.d, p.kv_len, p.hkv, p.k_st, p.k_sh, TK,
                  &k_inner) ||
      !tensor_map(&tm_v, p.v, DV, p.kv_len, p.hkv, p.v_st, p.v_sh, TK,
                  &v_inner) ||
      k_inner != v_inner)
    return cudaErrorInvalidValue;
  p.heads_inner = k_inner;
  const size_t bytes = tc_smem_bytes(p.d, DV, TK);
  auto kernel = flash_tc_kernel<DV, TK, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  if (p.tile_map != nullptr) {  // the CTAs' walks first
    p.walks = (p.qo_len * p.group + kRowsTc - 1) / kRowsTc * p.map_heads *
              p.splits;
    if (p.walk_ws == nullptr ||
        size_t(p.walks) * (1 + p.map_nt) > p.walk_ws_len)
      return cudaErrorInvalidValue;
    flash_walk_kernel<TK><<<(p.walks + 3) / 4, 128, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  } else {
    p.walk_ws = nullptr;
  }
  dim3 grid((p.qo_len * p.group + kRowsTc - 1) / kRowsTc, p.hkv, p.splits);
  kernel<<<grid, kTcThreads, bytes, s>>>(tm_k, tm_v, p);
  return cudaGetLastError();
}

template <bool G>
cudaError_t launch_tc(const Params& p, cudaStream_t s) {
  const bool wide = tc_tile_k(p.d, p.dv) == 128;
  switch (p.dv) {
    case 64: return wide ? launch_tc_at<64, 128, G>(p, s)
                         : launch_tc_at<64, 64, G>(p, s);
    case 128: return wide ? launch_tc_at<128, 128, G>(p, s)
                          : launch_tc_at<128, 64, G>(p, s);
    case 192: return launch_tc_at<192, 64, G>(p, s);
    case 256: return launch_tc_at<256, 64, G>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The tile map of a mask over [qo_len, kv_len] (packed bits, the caller's
// hook, or both) into tile_map uint8 [map_heads, ceil(qo_len * hq / hkv /
// 64), ceil(kv_len / 64)]; map_heads is hkv where the hook reads the head,
// else 1. fi_flash_attention reads it.
extern "C" int fi_flash_tile_map(const uint8_t* mask, uint8_t* tile_map,
                                 int qo_len, int kv_len, int hq, int hkv,
                                 int causal, int window_left, int map_heads,
                                 void* stream
#ifdef FI_USER_VARIANT
                                 , const UserParams* user
#endif
                                 ) {
  if (qo_len <= 0 || kv_len <= 0 || hkv <= 0 || hq % hkv != 0 ||
      tile_map == nullptr || (map_heads != 1 && map_heads != hkv) ||
      (mask == nullptr && !FI_USER_MASK))
    return int(cudaErrorInvalidValue);
  Params p{};
  p.mask = mask;
  p.qo_len = qo_len; p.kv_len = kv_len; p.hq = hq; p.hkv = hkv;
  p.group = hq / hkv; p.causal = causal; p.window_left = window_left;
  set_map_dims(p, tile_map, map_heads);
#ifdef FI_USER_VARIANT
  p.user = *user;
#endif
  const dim3 grid((p.map_nt + kMapWarps - 1) / kMapWarps, p.map_rb,
                  map_heads);
  flash_map_kernel<<<grid, 32 * kMapWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// tile_map: fi_flash_tile_map's output for the same mask, or null (every
// tile under a mask tested key by key); walk_ws: int32 scratch of
// walk_ws_len >= ceil(qo_len * hq / hkv / 128) * map_heads * splits * (1 +
// ceil(kv_len / 64)) elements for the CTAs' walks (bf16; a map only).
extern "C" int fi_flash_attention(
    const void* q, const void* k, const void* v, const uint8_t* mask,
    const uint8_t* tile_map, int map_heads, int* walk_ws,
    long long walk_ws_len,
    const float* alibi, const float* sink, void* o, float* lse,
    float* o_part, float* lse_part, long long q_st, long long q_sh,
    long long k_st, long long k_sh, long long v_st, long long v_sh,
    int qo_len, int kv_len, int hq, int hkv, int d, int dv, int causal,
    int window_left, int splits, float sm_scale, float soft_cap, int sigmoid,
    float sig_scale, float sig_bias, int dtype, void* stream
#ifdef FI_USER_VARIANT
    , const UserParams* user
#endif
    ) {
  if (qo_len <= 0 || kv_len < 0 || hkv <= 0 || hq % hkv != 0 || d % 16 != 0 ||
      d <= 0 || d > 256 || dv % 16 != 0 || dv <= 0 || dv > 256 || splits < 1 ||
      (splits > 1 && (o_part == nullptr || lse_part == nullptr)) ||
      (tile_map != nullptr && mask == nullptr && !FI_USER_MASK) ||
      (tile_map != nullptr && map_heads != 1 && map_heads != hkv))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.mask = mask; p.alibi = alibi; p.sink = sink;
  // more than one split: the kernel writes f32 partial states, the merge
  // kernel the outputs
  p.o = splits > 1 ? static_cast<void*>(o_part) : o;
  p.lse = splits > 1 ? lse_part : lse;
  p.q_st = q_st; p.q_sh = q_sh; p.k_st = k_st; p.k_sh = k_sh;
  p.v_st = v_st; p.v_sh = v_sh;
  p.qo_len = qo_len; p.kv_len = kv_len; p.hq = hq; p.hkv = hkv;
  p.group = hq / hkv; p.d = d; p.dv = dv;
  p.causal = causal; p.window_left = window_left; p.splits = splits;
  p.sigmoid = sigmoid;
  p.sm_scale = sm_scale;
  p.scale_log2 = float(double(sm_scale) * 1.4426950408889634);
  p.soft_cap = soft_cap; p.sig_scale = sig_scale; p.sig_bias = sig_bias;
  p.heads_inner = 0;
  set_map_dims(p, tile_map, map_heads);
  p.walk_ws = walk_ws;
  p.walk_ws_len = walk_ws_len > 0 ? size_t(walk_ws_len) : 0;
  p.walks = 0;
  // the default path folds its scale into the exponent after the row max,
  // which needs the scale positive
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#ifdef FI_USER_VARIANT
  // a caller's variant: its hooks on the elementwise path, its weights
  // added without softmax
  p.user = *user;
  p.sigmoid = sigmoid = !FI_USER_SOFTMAX;
  if (dtype == kBF16)
    err = launch_tc<true>(p, s);
  else if (dtype == kF32)
    err = launch_f32<true>(p, s);
  else
    err = cudaErrorInvalidValue;
#else
  const bool general =
      alibi != nullptr || soft_cap > 0.f || sigmoid || !(sm_scale > 0.f);
  if (dtype == kBF16) {
    err = general ? launch_tc<true>(p, s) : launch_tc<false>(p, s);
  } else if (dtype == kF32) {
    err = general ? launch_f32<true>(p, s) : launch_f32<false>(p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
#endif
  if (err != cudaSuccess || splits == 1) return int(err);
#ifdef FI_USER_VARIANT
#define FI_MERGE_USER , p.user
#else
#define FI_MERGE_USER
#endif
  if (dtype == kBF16)
    merge_splits_kernel<<<qo_len * hq, kThreads, 0, s>>>(
        o_part, lse_part, static_cast<__nv_bfloat16*>(o), lse, splits, hq, dv,
        sigmoid FI_MERGE_USER);
  else
    merge_splits_kernel<<<qo_len * hq, kThreads, 0, s>>>(
        o_part, lse_part, static_cast<float*>(o), lse, splits, hq, dv,
        sigmoid FI_MERGE_USER);
  return int(cudaGetLastError());
}
