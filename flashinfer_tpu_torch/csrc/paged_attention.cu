// Paged attention over a planned work list, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (flashinfer_tpu/ops/attention/
// kernels/paged.py:161, launched at :1099). It reads the same int32 plan (12
// rows of T work items; this kernel uses REQ, QO_TILE, QO_START, KV_START,
// KV_END, KV_PAGE_START and Q_POS_BASE and ignores the TPU DMA-dedup rows)
// and writes the same split-KV partials: o [T, kvh, tile_q, dv] in q's dtype
// and lse [T, kvh, tile_q] f32 (natural log; o = 0, lse = -inf for padding
// items, for padding rows (row_valid 0) and for rows that see no key).
//
// Numerics follow the TPU kernel: QK in f32 from exactly converted K values
// (bf16, e4m3 or int8), k_scale folded into the softmax scale with log2(e)
// so the online softmax runs on exp2 (after the soft cap when there is one),
// q and P rounded to bf16 wherever q is bf16 or the cache is e4m3 (the TPU
// kernel feeds its MXU in that dtype), v_scale applied once to the output.
//
// What bounds it on the H100: at decode the KV bytes (one read of every
// page of the batch: a few flops a byte), at prefill and in POD's combined
// plan the operations (4 * d flops a (row, key) pair). Design, for bf16
// numerics (bf16 q with any cache, or an e4m3 cache), on wgmma:
// - Prefill tiles (tile_q >= 64): a CTA per (work item, kv head, block of
//   128 packed rows), two consumer warpgroups of 64 GQA-packed rows: S =
//   Q.K^T with Q and K in 128-byte-swizzled shared memory; S's accumulators
//   are P's A fragment, so O += P.V is the register-A wgmma with V
//   MN-major and P never leaves registers (the flash kernel's structure).
// - Decode tiles (tile_q 8, 16, 32): swap-AB, a CTA per (item, kv head):
//   S^T = K.Q^T with 64 keys as wgmma's M and the tile's rows as its N, so
//   an 8-row tile runs no 64-row product; the row max crosses the four
//   warps through shared memory, and P^T (bf16, shared memory) is the B
//   operand of O^T = V^T.P^T.
// - Pages fed by a producer warpgroup: its first warp keeps a ring of K/V
//   stages full through TMA, with the page id in the coordinate of a 4-D
//   tensor map over the cache ([P, ps, kvh, d] NHD or [P, kvh, ps, d] HND),
//   lane b issuing box b (up to a page, a 64-column block) of each tile and
//   loading the next tile's page ids meanwhile.
// - Pages whose size is not a multiple of 8 tokens (12, 20, 9: any size)
//   are gathered instead, in this source's second build (FI_PAGED_GATHER,
//   csrc/paged_attention_gather.cu; the wrapper picks the build by page
//   size, and this one's instructions stay as they were): a TMA box of
//   gcd(page, tile) rows would be as small as one row and start inside a
//   128-byte swizzle atom. The producer warpgroup's 128 threads copy each
//   row's 16-byte chunks with cp.async into the same swizzled layout (the
//   row's page and slot from the page table, as the CUDA-core kernel
//   addresses it), zero-filling rows past the span and columns past the
//   width; one commit group a tile, published a tile behind (wait, proxy
//   fence, named barrier, one arrival), so the consumers run unchanged.
//   8-bit caches: the warpgroup that converts an operand copies its rows'
//   bytes into the byte stages with cp.async, each thread arriving on the
//   stage's barrier when its copies land (128 arrivals), and converts them
//   as with TMA.
// - 8-bit caches are read as bytes (half of bf16's): TMA brings byte
//   stages, and the producer warpgroup's four warps (at decode, two
//   warpgroups: one for K, one for V) convert them, exactly (e4m3x2 ->
//   f16x2 -> f32 -> bf16x2; int8 through the low mantissa of 2^23), into
//   the bf16 stages the consumers read, so no bf16 copy of a cache exists
//   in device memory and the consumers run one code path.
// - The online softmax subtracts the ceiling of the running base-2 max, so
//   every rescale is an exact power of two and P rounded to bf16 equals P
//   rounded against the final max, as the plain version rounds it.
// - Work that cannot matter is skipped: a row block whose rows are all
//   padding writes the merge identity and leaves (the plan's row_valid
//   segment); a CTA walks only the key tiles its rows need under causal
//   and the window (a tile only the other warpgroup's rows need is masked,
//   not skipped: no branch encloses the wgmma, which ptxas would otherwise
//   serialise).
// f32 numerics (f32 q with an f32 or int8 cache) run on the CUDA cores: a
// CTA per (item, kv head, 8 or 32 rows), 64-key tiles converted to f32 in
// shared memory, one or two output columns a thread.
//
// Masks and ALiBi, in all three kernels: a plan's work mask (uint8 [T,
// tile_q, chunk], the custom or multi-item mask legalised on the host) is
// read a byte a (row, key) where a tile is tested key by key. Its tile map
// (uint8 [T, row blocks of 64, key tiles of 64], built with the plan: bit
// kMapKeep where a real row keeps a key that the span, causal and the
// window allow, bit kMapDrop where the mask drops one) tells the kernels
// which key tiles to test: a launch before the attention lists, for each
// CTA, the tiles that a row block of it keeps a key of, with their classes
// (paged_walk_kernel, csrc/tile_walk.cuh), and the CTA's producer and
// consumers walk that list, skipping the other tiles (each would add
// nothing: every rescale by 2^0 and every P 0); a tile the mask keeps
// whole takes the mask-free path (the interior test, or the edge test
// without the mask's bytes); only the tiles it cuts read them. A tile that
// one row block skips and the other needs is computed, with the first's S
// masked by its bytes (no branch may enclose a wgmma). A CTA with no tile
// left writes the merge identity. Without a map every tile of a masked
// plan is tested key by key. ALiBi (slopes f32 [hq]) and the soft cap take
// the elementwise path after S: scale, + slope * (kv_pos - q_pos), cap,
// then log2(e), in the plain version's order and roundings; the default
// path (neither) keeps its scale folded into the exponent.
//
// A caller's variant (flashinfer_tpu_torch/jit/variant.py) arrives as a
// generated header, passed by -include with -DFI_USER_VARIANT (its hooks
// user_logits, user_mask and user_q, their flags FI_USER_HAS_*, and the
// UserParams its leaves travel in), in all three kernels: the logits hook
// on s * sm_scale * k_scale in place of general_logit's transform, then
// log2(e); the mask ANDed where keep() reads the work mask, which turns off
// the mask-free interior tiles; the q hook on each q element in f32 before
// q is rounded to bf16. The head is the row's true query head. Hooks see
// real positions only: keys past the item's span take its last key's
// position and rows past its last real row that row's token (their values
// are masked or dropped). The output hook is not applied, as the TPU
// kernel applies none; softmax only. Without the macro nothing changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"
#include "tile_walk.cuh"
#include "wgmma.cuh"

// 1 in the gather build (pages of any size, by cp.async), 0 in the TMA one
#ifndef FI_PAGED_GATHER
#define FI_PAGED_GATHER 0
#endif

namespace {

constexpr bool kGather = FI_PAGED_GATHER;

enum PlanRow {
  kReq = 0, kQoTile = 1, kQoStart = 3, kKvStart = 5, kKvEnd = 6,
  kKvPageStart = 7, kQPosBase = 9,
};

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kI8 = 3 };

constexpr int kWgRows = 64;       // packed rows a consumer warpgroup
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448 - 256;  // bytes a CTA may use (H100)
constexpr int kThreads = 128;     // CUDA-core kernel
constexpr int kTileF32 = 64;      // keys a tile, CUDA-core kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;          // [kvh, q_rows, d], bf16 or f32
  const void* k;          // NHD [P, ps, kvh, d] or HND [P, kvh, ps, d]
  const void* v;          // the same with dv
  const int* plan;        // [12 * T]
  const int* kv_indices;  // page table
  const int* row_valid;   // [q_rows] or null (every row real)
  const unsigned char* work_mask;  // [T, tile_q, mask_chunk] or null
  const unsigned char* tile_map;   // [T, map_rb, map_nt] or null
  const float* alibi;     // [kvh * group] ALiBi slopes, or null
  void* o;                // [T, kvh, tile_q, dv] in q's dtype
  float* lse;             // [T, kvh, tile_q]
  int T, kvh, q_rows, tile_q, d, dv, page_size, layout_hnd;
  int kv_indices_offset, group, causal, window_left, q_f32, kv_i8;
  int mask_chunk;  // keys a work-mask row holds (the plan's kv_chunk_size)
  int map_rb, map_nt;  // the tile map's row blocks and key tiles an item
  // the walks (with a map): [CTAs] counts, then [CTAs][map_nt] lists
  int* walk_ws;
  size_t walk_ws_len;  // ints
  int walk_ctas;
  int box_rows, stages, byte_stages;  // tensor-core kernel
  float scale_log2;  // sm_scale * k_scale * log2(e)
  float sm_scale;    // sm_scale * k_scale (soft cap path)
  float soft_cap, v_scale;
#ifdef FI_USER_VARIANT
  UserParams user;
#endif
};


struct Item {
  int w, qo_tile, qo_start, kv_start, span, page0, q_pos_base;
};

__device__ __forceinline__ Item load_item(const Params& p, int w) {
  const int T = p.T;
  Item it;
  it.w = w;
  it.qo_tile = p.plan[kQoTile * T + w];
  it.qo_start = p.plan[kQoStart * T + w];
  it.kv_start = p.plan[kKvStart * T + w];
  it.span = p.plan[kReq * T + w] < 0 ? 0 : p.plan[kKvEnd * T + w] - it.kv_start;
  it.page0 = p.plan[kKvPageStart * T + w];
  it.q_pos_base = p.plan[kQPosBase * T + w];
  return it;
}

// Absolute position of the token of row r of the item's tile.
__device__ __forceinline__ int q_tok(const Params& p, const Item& it, int r) {
  return it.q_pos_base + (it.qo_tile * p.tile_q + r) / p.group;
}

__device__ __forceinline__ bool row_ok(const Params& p, const Item& it,
                                       int r) {
  return r < p.tile_q && it.qo_start + r < p.q_rows &&
         (p.row_valid == nullptr || p.row_valid[it.qo_start + r] != 0);
}

// Keys [lo, hi) of the item (local indices) that rows first..last need.
__device__ __forceinline__ void key_range(const Params& p, const Item& it,
                                          int first, int last, int& lo,
                                          int& hi) {
  hi = it.span;
  if (p.causal) hi = min(hi, q_tok(p, it, last) - it.kv_start + 1);
  lo = 0;
  if (p.window_left >= 0)
    lo = max(0, q_tok(p, it, first) - p.window_left - it.kv_start);
  if (hi < lo) hi = lo;
}

// Whether the row at tok may see the item's local key lk at all: inside
// the span, causal, the window.
__device__ __forceinline__ bool in_span(const Params& p, const Item& it,
                                       int tok, int lk) {
  const int pos = it.kv_start + lk;
  return lk < it.span && !(p.causal && pos > tok) &&
         !(p.window_left >= 0 && pos < tok - p.window_left);
}

// Whether row r (its token at tok) sees the item's local key lk.
__device__ __forceinline__ bool keep(const Params& p, const Item& it, int r,
                                     int tok, int lk) {
  return in_span(p, it, tok, lk) &&
         (p.work_mask == nullptr ||
          (r < p.tile_q &&
           p.work_mask[(size_t(it.w) * p.tile_q + r) * p.mask_chunk + lk]));
}

// The map's bits for row block rb of item w over key tile t of `per` 64-key
// tiles of the map (ORed; tiles past the map hold nothing).
__device__ __forceinline__ int map_class(const Params& p, int w, int rb,
                                         int t, int per) {
  const unsigned char* m =
      p.tile_map + (size_t(w) * p.map_rb + rb) * p.map_nt;
  int c = 0;
  for (int s = 0; s < per; ++s) {
    const int j = t * per + s;
    if (j < p.map_nt) c |= m[j];
  }
  return c;
}

// The walks of a tile map (before the attention launch): a warp a CTA (work
// item w, row blocks [z * blocks, (z + 1) * blocks) of 64 rows), listing
// in order the tiles of tk keys of the item that a row block keeps a key
// of. The map holds real rows and keys in reach only, so a tile outside
// the CTA's causal and window range carries no bit.
__global__ void __launch_bounds__(128)
    paged_walk_kernel(const Params p, int tk, int nz, int blocks) {
  const int cta = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (cta >= p.walk_ctas) return;
  const int w = cta / nz, rb0 = (cta % nz) * blocks, per = tk / kMapKeys;
  list_tiles(
      [&](int t) {
        int c = 0;
        for (int b = 0; b < blocks; ++b)
          if (rb0 + b < p.map_rb)
            c |= map_class(p, w, rb0 + b, t, per) << (2 * b);
        return c;
      },
      0, (p.map_nt + per - 1) / per,
      reinterpret_cast<uint32_t*>(p.walk_ws + p.walk_ctas) +
          size_t(cta) * p.map_nt,
      p.walk_ws + cta, lane);
}

// CTA cta's walk: its list (a map) or every tile of [t0, t1) of classes
// `bits`; its length from *s_walk, which thread 0 set before a barrier.
__device__ __forceinline__ Walk cta_walk(const Params& p, int cta, int t0,
                                         int bits, const int* s_walk) {
  return Walk{p.walk_ws ? reinterpret_cast<const uint32_t*>(
                              p.walk_ws + p.walk_ctas) +
                              size_t(cta) * p.map_nt
                        : nullptr,
              t0, *s_walk, bits};
}

// The length of CTA cta's walk, for thread 0 to publish.
__device__ __forceinline__ int walk_length(const Params& p, int cta, int t0,
                                           int t1) {
  return p.walk_ws ? p.walk_ws[cta] : (t1 > t0 ? t1 - t0 : 0);
}

// ALiBi's slope for row r of kv head h: its query head is h * group + its
// packed row's index in the request modulo the group.
__device__ __forceinline__ float alibi_slope(const Params& p, const Item& it,
                                             int h, int r) {
  return p.alibi == nullptr
             ? 0.f
             : p.alibi[h * p.group + (it.qo_tile * p.tile_q + r) % p.group];
}

// The elementwise path's base-2 logit of raw score s (row at tok, key at
// pos): the scale, ALiBi's bias, the soft cap, then log2(e). Explicit
// roundings keep the compiler from fusing the multiply and the add, which
// the plain version rounds apart.
__device__ __forceinline__ float general_logit(const Params& p, float s,
                                               float slope, int tok, int pos) {
  if (p.alibi == nullptr && !(p.soft_cap > 0.f)) return s * p.scale_log2;
  float x = __fmul_rn(s, p.sm_scale);
  if (p.alibi != nullptr)
    x = __fadd_rn(x, __fmul_rn(slope, float(pos - tok)));
  if (p.soft_cap > 0.f) return p.soft_cap * tanhf(x / p.soft_cap) * kLog2e;
  return __fmul_rn(x, kLog2e);
}

#ifdef FI_USER_VARIANT
// The true query head of row r of kv head h (the head alibi_slope reads).
__device__ __forceinline__ int row_head(const Params& p, const Item& it, int h,
                                        int r) {
  return h * p.group + (it.qo_tile * p.tile_q + r) % p.group;
}

// The caller's logits hook on raw score s of the row at tok (clamped to
// the last real row's) and key at pos, then log2(e); explicit roundings as
// general_logit's.
__device__ __forceinline__ float user_logit(const Params& p, const Item& it,
                                            float s, int head, int tok,
                                            int pos) {
  float x = __fmul_rn(s, p.sm_scale);
#if FI_USER_HAS_LOGITS
  x = user_logits(x, tok, min(pos, it.kv_start + it.span - 1), head, p.user);
#endif
  return __fmul_rn(x, kLog2e);
}

// Whether the caller's mask keeps local key lk of the row at tok; asked
// only of keys keep() keeps.
__device__ __forceinline__ bool user_keep(const Params& p, const Item& it,
                                          int head, int tok, int lk) {
#if FI_USER_HAS_MASK
  return user_mask(tok, it.kv_start + lk, head, p.user);
#else
  return true;
#endif
}

// Eight q values of `head` through the q hook, in f32, packed as bf16.
__device__ __forceinline__ uint4 user_q_pack8(const float* f, int head,
                                              const UserParams& u) {
  float g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = user_q(f[j], head, u);
  return make_uint4(pack_bf16(g[0], g[1]), pack_bf16(g[2], g[3]),
                    pack_bf16(g[4], g[5]), pack_bf16(g[6], g[7]));
}

// Eight q values (f32 or bf16, as the kernel holds q) at q + off.
__device__ __forceinline__ void load_q8(const Params& p, size_t off,
                                        float* f) {
  if (p.q_f32) {
    const float4* src =
        reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + off);
    const float4 a = src[0], b = src[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.q) + off);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(v[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
}
#endif

#if defined(FI_USER_VARIANT) && FI_USER_HAS_MASK
#define FI_USER_MASK 1
#else
#define FI_USER_MASK 0
#endif

// The merge identity (o = 0, lse = -inf) for rows [r0, r1) of item w, head h.
__device__ void write_identity(const Params& p, int w, int h, int r0, int r1,
                               int tid, int nthreads) {
  r1 = min(r1, p.tile_q);
  if (r1 <= r0) return;
  const size_t row = (size_t(w) * p.kvh + h) * p.tile_q + r0;
  const int n = (r1 - r0) * p.dv;
  if (p.q_f32) {
    float* o = static_cast<float*>(p.o) + row * p.dv;
    for (int i = tid; i < n; i += nthreads) o[i] = 0.f;
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + row * p.dv;
    for (int i = tid; i < n; i += nthreads) o[i] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < r1 - r0; i += nthreads) p.lse[row + i] = -CUDART_INF_F;
}

// The factor a row's accumulator is multiplied by, and its natural-log lse,
// from its base-2 max m and sum l.
__device__ __forceinline__ float finish_row(const Params& p, float m, float l,
                                            float* lse) {
  const float m_safe = (m == -CUDART_INF_F) ? 0.f : m;
  *lse = l > 0.f ? m_safe * kLn2 + logf(l) : -CUDART_INF_F;
  return l > 0.f ? p.v_scale / l : 0.f;
}

// ------------------------------------------------------------ tensor cores

// Converts an 8-bit stage (TK rows of `width` bytes) into a bf16 stage of
// `blocks` 64-column blocks in the 128-byte swizzle; rows from `valid` on
// and columns from `width` on become 0 (so stale or unwritten bytes never
// reach a product). ct: this thread among the 128 of the producer
// warpgroup.
template <int TK, bool I8, int UNROLL>
__device__ __forceinline__ void convert_stage(const unsigned char* src,
                                              unsigned char* dst, int width,
                                              int blocks, int valid, int ct) {
  const int per_row = blocks * 4;  // 16-column chunks a row
#pragma unroll UNROLL
  for (int i = ct; i < TK * per_row; i += 128) {
    const int j = i / per_row, col = (i % per_row) * 16;
    uint2 a = make_uint2(0u, 0u), b = a, c = a, e = a;
    if (j < valid && col < width) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + j * width + col);
      a = bytes4_to_bf16x4<I8>(x.x);
      b = bytes4_to_bf16x4<I8>(x.y);
      c = bytes4_to_bf16x4<I8>(x.z);
      e = bytes4_to_bf16x4<I8>(x.w);
    }
    unsigned char* blk = dst + (col >> 6) * TK * 128;
    const int ch = (col & 63) >> 3;
    *reinterpret_cast<uint4*>(blk + sw128(j, ch)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(blk + sw128(j, ch + 1)) =
        make_uint4(c.x, c.y, e.x, e.y);
  }
}

// Shared memory of the tensor-core kernel: Q ([2 or 1][d blocks][64 rows]
// [128 B]); `s` bf16 stages of K [d blocks][tk][128 B] and V [dv blocks]
// [tk][128 B]; with an 8-bit cache `s8` byte stages of K [tk][d] and V
// [tk][dv]; the barriers; 1024 bytes of slack to align the swizzle atoms.
__host__ __device__ __forceinline__ int round1024(int x) {
  return (x + 1023) & ~1023;
}
size_t tc_smem(int d, int dv, int dvp, int tk, int q_blocks, int s, int s8) {
  const int qb = (d + 63) / 64, vb = dvp / 64;
  return 1024 + size_t(q_blocks) * qb * kWgRows * 128 +
         size_t(s) * (qb + vb) * tk * 128 +
         size_t(s8) * (round1024(tk * d) + round1024(tk * dv)) +
         8 * (4 * s + 4 * s8);
}

struct TcGeo {
  int tk, stages, byte_stages;
  size_t smem;
};


// Two consumer warpgroups of 64 rows each; 128 keys a tile where S beside
// O and two stages fit (else 64); two bf16 stages, then as many byte
// stages (<= 4) as fit.
TcGeo tc_geo(int d, int dv, int dvp, bool kv8) {
  const int s8_min = kv8 ? 1 : 0, q_blocks = 2;
  TcGeo g;
  g.tk = dvp <= 128 &&
                 tc_smem(d, dv, dvp, 128, q_blocks, 2, s8_min) <= kSmemLimit
             ? 128 : 64;
  g.stages = 2;
  g.byte_stages = s8_min;
  while (kv8 && g.byte_stages < kMaxStages &&
         tc_smem(d, dv, dvp, g.tk, q_blocks, g.stages, g.byte_stages + 1) <=
             kSmemLimit)
    ++g.byte_stages;
  g.smem = tc_smem(d, dv, dvp, g.tk, q_blocks, g.stages, g.byte_stages);
  return g;
}

// Page ids of tile t's boxes: lane b holds box b's (0 past the span).
template <int TK>
__device__ __forceinline__ int box_page(const Params& p, const Item& it,
                                        int t, int lane) {
  const int lk = t * TK + lane * p.box_rows;
  return (lane < TK / p.box_rows && lk < it.span)
             ? p.kv_indices[it.page0 + lk / p.page_size] + p.kv_indices_offset
             : 0;
}

// Zeroes rows [valid, TK) of a bf16 V stage of kVB 64-column blocks (the
// warpgroup's 128 threads, then its named barrier `bar`): rows past the
// span hold other tokens or stale bytes; their P is 0, but a NaN there
// would still reach o.
template <int TK, int kVB>
__device__ __noinline__ void zero_tail_rows(unsigned char* vs, int valid,
                                            int wtid, int bar) {
  for (int k = wtid; k < (TK - valid) * kVB * 8; k += 128) {
    const int j = valid + k / (kVB * 8), cb = (k / 8) % kVB;
    *reinterpret_cast<uint4*>(vs + cb * TK * 128 + j * 128 + (k % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// A ring of K/V stages in shared memory and its full/empty barriers.
struct Ring {
  unsigned char* k;
  unsigned char* v;
  int k_stage, v_stage, n;  // bytes a stage; stages
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
};

// 16 bytes from global src to shared dst by cp.async; src_bytes 0 writes
// zeros and reads nothing. No memory clobber: the copies are ordered by
// the commit / wait / arrive below, and the compiler may hoist the page
// table's loads across them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// One arrival on bar once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Local key lk's row of kv head h in the cache's rows of one head: its
// page from the page table and its slot in that page, at any page size.
__device__ __forceinline__ unsigned key_row(const Params& p, const Item& it,
                                            int h, int lk) {
  const unsigned page =
      p.kv_indices[it.page0 + lk / p.page_size] + p.kv_indices_offset;
  const unsigned slot = lk % p.page_size;
  return p.layout_hnd ? (page * p.kvh + h) * p.page_size + slot
                      : (page * p.page_size + slot) * p.kvh + h;
}

// Tile t of one bf16 operand (`width` columns, `blocks` 64-column blocks)
// into a stage in the 128-byte swizzle, a 16-byte cp.async a chunk (ct:
// this thread among the producer warpgroup's 128). Warp w copies rows
// [w TK/4, (w + 1) TK/4): lane l reads row l's page from the table once,
// and each chunk takes its row from that lane by a shuffle (neighbouring
// lanes on one row's neighbouring chunks). Rows past the span and
// columns past the width are zero-filled.
template <int TK>
__device__ __forceinline__ void gather_bf16(const Params& p, const Item& it,
                                            const void* cache, int h, int t,
                                            int width, int blocks,
                                            unsigned char* dst, int ct) {
  constexpr int R = TK / 4;  // rows a warp copies
  const int lane = ct & 31, j0 = (ct >> 5) * R;
  const int valid = min(TK, it.span - t * TK), per_row = blocks * 8;
  const unsigned row = lane < R && j0 + lane < valid
                           ? key_row(p, it, h, t * TK + j0 + lane) : 0u;
  const unsigned char* base = static_cast<const unsigned char*>(cache);
  for (int i = lane; i < R * per_row; i += 32) {  // R * per_row % 32 == 0
    const int r = i / per_row, c = i - r * per_row, j = j0 + r;
    const unsigned src = __shfl_sync(0xffffffffu, row, r);
    const bool real = j < valid && c * 8 < width;
    cp_async16(dst + (c >> 3) * TK * 128 + sw128(j, c & 7),
               base + (real ? size_t(src) * (width * 2) + c * 16 : 0),
               real ? 16 : 0);
  }
}

// The bf16 ring filled by gathering (kGather), the walk's tiles: each
// thread of the producer warpgroup copies its chunks of a tile as one
// commit group, then the tile before is published once its group has
// landed:
// every thread fences its copies for the async proxy (wgmma), the
// warpgroup meets at named barrier 4, one thread arrives on the full
// barriers (one arrival each, as a TMA tile's). Keeping more tiles in
// flight on the decode kernel's deeper ring measured no faster.
template <int TK>
__device__ __forceinline__ void gather_ring(const Params& p, const Item& it,
                                            int h, const Ring& r,
                                            int blocks_k, int blocks_v,
                                            const Walk& walk, int wtid) {
  auto publish = [&](int i) {
    fence_async_smem();
    asm volatile("bar.sync 4, 128;\n" ::: "memory");
    if (wtid == 0) {
      mbar_arrive(&r.full_k[i % r.n]);
      mbar_arrive(&r.full_v[i % r.n]);
    }
  };
  for (int i = 0; i < walk.n; ++i) {
    const int t = walk.tile(i), st = i % r.n, ph = (i / r.n) & 1;
    mbar_wait(&r.empty_k[st], ph ^ 1);
    gather_bf16<TK>(p, it, p.k, h, t, p.d, blocks_k, r.k + st * r.k_stage,
                    wtid);
    mbar_wait(&r.empty_v[st], ph ^ 1);
    gather_bf16<TK>(p, it, p.v, h, t, p.dv, blocks_v, r.v + st * r.v_stage,
                    wtid);
    cp_async_commit();
    if (i > 0) {
      cp_async_wait<1>();
      publish(i - 1);
    }
  }
  if (walk.n > 0) {
    cp_async_wait<0>();
    publish(walk.n - 1);
  }
}

// Tile t's rows of one 8-bit operand (`width` bytes a row) into a byte
// stage [TK][width] by cp.async (ct: this thread among the 128 of the
// warpgroup that converts the operand). Warp w copies rows [w TK/4,
// (w + 1) TK/4), lane l reading row l's page once and the chunks taking
// it by a shuffle; rows past the span are left unwritten (the converters
// zero them). Each thread then arrives on `full` once its copies land
// (the byte ring's full barriers take 128 arrivals when gathering).
template <int TK>
__device__ __forceinline__ void gather_bytes(const Params& p, const Item& it,
                                             const void* cache, int h, int t,
                                             int width, unsigned char* dst,
                                             uint64_t* full, int ct) {
  constexpr int R = TK / 4;  // rows a warp copies
  const int lane = ct & 31, j0 = (ct >> 5) * R;
  const int valid = min(TK, it.span - t * TK), per_row = width / 16;
  const unsigned row = lane < R && j0 + lane < valid
                           ? key_row(p, it, h, t * TK + j0 + lane) : 0u;
  const unsigned char* base = static_cast<const unsigned char*>(cache);
  for (int i0 = 0; i0 < R * per_row; i0 += 32) {  // the same trips a lane
    const int i = i0 + lane, r = i / per_row, c = i - r * per_row;
    const unsigned src = __shfl_sync(0xffffffffu, row, r & 31);
    if (i < R * per_row && j0 + r < valid)
      cp_async16(dst + (j0 + r) * width + c * 16,
                 base + size_t(src) * width + c * 16, 16);
  }
  cp_async_arrive(full);
}

// issue_tile's byte stages of tile t (ring stage i % n) where the pages
// are gathered (kGather), by the warpgroup that converts them (part 0:
// K and V, part 1: K, part 2: V), each operand once its stage is free.
template <int TK>
__device__ __forceinline__ void gather_tile8(const Params& p, const Item& it,
                                             int h, const Ring& r, int t,
                                             int i, int part, int ct) {
  const int st = i % r.n, ph = (i / r.n) & 1;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    if (part == 2 - kv) continue;  // the other warpgroup's operand
    if ((ct & 31) == 0)
      mbar_wait(kv ? &r.empty_v[st] : &r.empty_k[st], ph ^ 1);
    __syncwarp();
    gather_bytes<TK>(p, it, kv ? p.v : p.k, h, t, kv ? p.dv : p.d,
                     kv ? r.v + st * r.v_stage : r.k + st * r.k_stage,
                     kv ? &r.full_v[st] : &r.full_k[st], ct);
  }
}

// Issues tile t's K then V boxes into ring stage i % n, one TMA box a
// (page part, 64-column block) for bf16, a page part of all columns for
// 8-bit; lane b issues box b, so a tile's boxes go out together.
template <int TK, bool KV8>
__device__ __forceinline__ void issue_tile(const Params& p, const Item& it,
                                           int h, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v,
                                           const Ring& r, int blocks_k,
                                           int blocks_v, int t, int i,
                                           int page, int lane) {
  const int br = p.box_rows, st = i % r.n, ph = (i / r.n) & 1;
  const int nbox = (min(TK, it.span - t * TK) + br - 1) / br;
  const int slot = (t * TK + lane * br) % p.page_size;
  const int c1 = p.layout_hnd ? slot : h, c2 = p.layout_hnd ? h : slot;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    uint64_t* full = kv ? &r.full_v[st] : &r.full_k[st];
    const CUtensorMap* tm = kv ? tm_v : tm_k;
    unsigned char* dst = kv ? r.v + st * r.v_stage : r.k + st * r.k_stage;
    const int blocks = kv ? blocks_v : blocks_k;
    const int width = kv ? p.dv : p.d;  // bytes a row, 8-bit
    if (lane == 0) {
      mbar_wait(kv ? &r.empty_v[st] : &r.empty_k[st], ph ^ 1);
      mbar_expect_tx(full, KV8 ? nbox * br * width : nbox * blocks * br * 128);
    }
    __syncwarp();
    if (lane < nbox) {
      if (KV8) {
        tma_load4(dst + lane * br * width, tm, full, 0, c1, c2, page);
      } else {
        for (int cb = 0; cb < blocks; ++cb)
          tma_load4(dst + cb * TK * 128 + lane * br * 128, tm, full, cb * 64,
                    c1, c2, page);
      }
    }
  }
}

// A producer warpgroup for the walk's key tiles: warp 0 issues TMA into
// the bf16 ring `ring` (blocks_k / blocks_v 64-column blocks), or for an
// 8-bit cache into the byte ring `bytes`, S8 - 1 tiles ahead; then all four
// warps convert each byte stage into the bf16 stage the consumers read:
// K and V (part 0), or K only (part 1, which also issues the loads) or V
// only (part 2) where two warpgroups share the conversion (named barrier
// 4 + part). The bf16 ring's full barriers take one arrival. The gather build
// (kGather) copies pages by cp.async instead: the bf16 ring by
// gather_ring, the byte ring by gather_tile8.
// UNROLL: chunks a converting thread has in flight (as its registers allow).
template <int TK, bool KV8, int UNROLL>
__device__ __forceinline__ void produce(const Params& p, const Item& it,
                                        int h, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const Ring& ring, const Ring& bytes,
                                        int blocks_k, int blocks_v,
                                        const Walk& walk, int part,
                                        int wtid) {
  const int warp = wtid >> 5, lane = wtid & 31;
  if (!KV8) {
    if constexpr (kGather) {
      gather_ring<TK>(p, it, h, ring, blocks_k, blocks_v, walk, wtid);
    } else {
      if (warp != 0) return;
      int next = walk.n > 0 ? box_page<TK>(p, it, walk.tile(0), lane) : 0;
      for (int i = 0; i < walk.n; ++i) {
        const int page = next;
        if (i + 1 < walk.n) next = box_page<TK>(p, it, walk.tile(i + 1), lane);
        issue_tile<TK, false>(p, it, h, tm_k, tm_v, ring, blocks_k, blocks_v,
                              walk.tile(i), i, page, lane);
      }
    }
    return;
  }
  const int S8 = bytes.n;
  auto issue = [&](int j) {  // the walk's tile j into byte stage j % S8
    const int t = walk.tile(j);
    if constexpr (kGather)
      gather_tile8<TK>(p, it, h, bytes, t, j, part, wtid);
    else
      issue_tile<TK, true>(p, it, h, tm_k, tm_v, bytes, 1, 1, t, j,
                           box_page<TK>(p, it, t, lane), lane);
  };
  // every converting thread copies its operand's bytes when gathering
  const bool issuer = kGather || (warp == 0 && part != 2);
  if (issuer)
    for (int j = 0; j < min(walk.n, S8 - 1); ++j) issue(j);
  for (int i = 0; i < walk.n; ++i) {
    const int t = walk.tile(i);
    if (issuer && i + S8 - 1 < walk.n) issue(i + S8 - 1);
    const int st = i % ring.n, ph = (i / ring.n) & 1;
    const int s8 = i % S8, ph8 = (i / S8) & 1;
    const int valid = min(TK, it.span - t * TK);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      if (part == 2 - kv) continue;  // the other warpgroup's operand
      const unsigned char* src =
          kv ? bytes.v + s8 * bytes.v_stage : bytes.k + s8 * bytes.k_stage;
      unsigned char* dst =
          kv ? ring.v + st * ring.v_stage : ring.k + st * ring.k_stage;
      const int width = kv ? p.dv : p.d, blocks = kv ? blocks_v : blocks_k;
      mbar_wait(kv ? &bytes.full_v[s8] : &bytes.full_k[s8], ph8);
      mbar_wait(kv ? &ring.empty_v[st] : &ring.empty_k[st], ph ^ 1);
      if (p.kv_i8)
        convert_stage<TK, true, UNROLL>(src, dst, width, blocks, valid, wtid);
      else
        convert_stage<TK, false, UNROLL>(src, dst, width, blocks, valid, wtid);
      // the bf16 stage is visible to wgmma once every thread's writes are
      // fenced; the warpgroup meets at its named barrier and one thread
      // arrives
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(kv ? &bytes.empty_v[s8] : &bytes.empty_k[s8]);
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + part) : "memory");
      if (wtid == 0) mbar_arrive(kv ? &ring.full_v[st] : &ring.full_k[st]);
    }
  }
}

// Initialises a ring's barriers (thread 0): full takes `full` arrivals,
// empty `empty`.
__device__ __forceinline__ void init_ring(const Ring& r, int full, int empty) {
  for (int i = 0; i < r.n; ++i) {
    mbar_init(&r.full_k[i], full);
    mbar_init(&r.full_v[i], full);
    mbar_init(&r.empty_k[i], empty);
    mbar_init(&r.empty_v[i], empty);
  }
}

// A ring at `at` of n stages of k_stage + v_stage bytes, its barriers at
// `bars` (4 n of them).
__device__ __forceinline__ Ring make_ring(unsigned char* at, int k_stage,
                                          int v_stage, int n,
                                          uint64_t* bars) {
  return Ring{at, at + n * k_stage, k_stage, v_stage, n, bars, bars + n,
              bars + 2 * n, bars + 3 * n};
}

// Launch bounds of three warpgroups: ptxas then sizes the kernel below
// every setmaxnreg target (168 registers), so the consumers'
// setmaxnreg.inc always grows their share.
template <int DV, int TK, bool KV8>
__global__ void __launch_bounds__(384, 1)
    paged_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kS = TK / 2;    // S accumulators a thread
  constexpr int kO = DV / 2;    // O accumulators a thread
  constexpr int kVB = DV / 64;  // V column blocks
  constexpr int kRows = 2 * kWgRows;  // rows a CTA
  constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_last[2];  // last real row of each row block, or -1
  __shared__ int s_walk;     // tiles the CTA walks
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int d = p.d, qb = (d + 63) / 64, S = p.stages, S8 = p.byte_stages;
  const int k_stage = qb * TK * 128, v_stage = kVB * TK * 128;
  const int kb_stage = round1024(TK * d), vb_stage = round1024(TK * p.dv);
  unsigned char* sQ = base;
  unsigned char* sK = sQ + 2 * qb * kWgRows * 128;
  unsigned char* sB = sK + S * (k_stage + v_stage);  // 8-bit byte stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sB + S8 * (kb_stage + vb_stage));
  const Ring ring = make_ring(sK, k_stage, v_stage, S, bars);
  const Ring bytes = make_ring(sB, kb_stage, vb_stage, S8, bars + 4 * S);
  unsigned char* sV = ring.v;

  const int w = blockIdx.x, h = blockIdx.y, row0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31;
  const Item it = load_item(p, w);
  if (it.span <= 0) {  // padding item
    write_identity(p, w, h, row0, row0 + kRows, tid, 384);
    return;
  }
  if (tid < 2) s_last[tid] = -1;
  __syncthreads();
  if (tid < kRows && row_ok(p, it, row0 + tid))
    atomicMax(&s_last[tid / kWgRows], row0 + tid);
  __syncthreads();
  const int last_of[2] = {s_last[0], s_last[1]};
  int active = 0, lo = 1 << 30, hi = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (last_of[c] < 0) continue;
    ++active;
    int l, u;
    key_range(p, it, row0 + c * kWgRows, last_of[c], l, u);
    if (u > l) {
      lo = min(lo, l);
      hi = max(hi, u);
    }
  }
  if (active == 0) {  // every row padding: the identity, nothing read
    write_identity(p, w, h, row0, row0 + kRows, tid, 384);
    return;
  }
  const int t0 = hi > lo ? lo / TK : 0, t1 = hi > lo ? (hi + TK - 1) / TK : 0;
  // a tile's classes without a map: the work mask cuts every tile
  const int mask_cls = p.work_mask ? kMapKeep | kMapDrop : kMapKeep;
  const int cta = w * gridDim.z + blockIdx.z;

  if (tid == 0) {
    s_walk = walk_length(p, cta, t0, t1);
    // empty: one arrival a consumer warp (a converter warp, byte ring)
    init_ring(ring, 1, 4 * active);
    init_ring(bytes, kGather ? 128 : 1, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk walk = cta_walk(p, cta, t0, mask_cls | mask_cls << 2, &s_walk);
  if (p.walk_ws != nullptr && walk.n == 0) {  // the mask keeps no key here
    write_identity(p, w, h, row0, row0 + kRows, tid, 384);
    return;
  }

  if (wg == 2) {  // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<TK, KV8, 1>(p, it, h, &tm_k, &tm_v, ring, bytes, qb, kVB, walk, 0,
                        wtid);
    return;
  }

  // ---- consumers: 64 packed rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wrow0 = row0 + wg * kWgRows;
  const int last = last_of[wg];
  if (last < 0) {  // padding rows only
    write_identity(p, w, h, wrow0, wrow0 + kWgRows, wtid, 128);
    return;
  }
  const int warp = wtid >> 5, g = lane >> 2, tq = lane & 3;

  // Q as bf16: zero past the tile and past d
  unsigned char* sQw = sQ + wg * qb * kWgRows * 128;
  for (int i = wtid; i < kWgRows * qb * 8; i += 128) {
    const int r = i / (qb * 8), cb = (i / 8) % qb, c = i % 8;
    const int lr = wrow0 + r, col = cb * 64 + c * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (lr < p.tile_q && it.qo_start + lr < p.q_rows && col < d) {
      const size_t off = (size_t(h) * p.q_rows + it.qo_start + lr) * d + col;
#if defined(FI_USER_VARIANT) && FI_USER_HAS_Q
      float f[8];
      load_q8(p, off, f);
      x = user_q_pack8(f, row_head(p, it, h, lr), p.user);
#else
      if (p.q_f32) {
        const float4* src =
            reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + off);
        const float4 a = src[0], b = src[1];
        x = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                       pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      } else {
        x = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.q) + off);
      }
#endif
    }
    *reinterpret_cast<uint4*>(sQw + cb * kWgRows * 128 + sw128(r, c)) = x;
  }
  fence_async_smem();  // Q is visible to this warpgroup's wgmma
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  const int tok_lo = q_tok(p, it, wrow0), tok_hi = q_tok(p, it, last);
  const int ra = wrow0 + warp * 16 + g, rb = ra + 8;
  const int tok_a = q_tok(p, it, ra), tok_b = q_tok(p, it, rb);
  const float slope_a = alibi_slope(p, it, h, ra);
  const float slope_b = alibi_slope(p, it, h, rb);
  // the default path folds its scale into the exponent after the row max,
  // which needs it positive; ALiBi, the soft cap and any other scale go
  // elementwise
#ifdef FI_USER_VARIANT
  // (a caller's logits hook too); its rows' heads and clamped tokens
  const bool general = FI_USER_HAS_LOGITS || !(p.scale_log2 > 0.f);
  const int head_a = row_head(p, it, h, ra), head_b = row_head(p, it, h, rb);
  const int utok_a = min(tok_a, tok_hi), utok_b = min(tok_b, tok_hi);
#else
  const bool general =
      p.soft_cap > 0.f || p.alibi != nullptr || !(p.scale_log2 > 0.f);
#endif
  const int tail = it.span % TK ? it.span / TK : -1;  // the tile ending inside

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < walk.n; ++i) {
    // every tile the CTA walks: a key this warpgroup's rows do not see is
    // masked (P = 0), so no branch encloses the products
    const int t = walk.tile(i), st = i % S, ph = (i / S) & 1;
    const unsigned char* ks = sK + st * k_stage;
    unsigned char* vs = sV + st * v_stage;
    float s[kS];
    mbar_wait(&ring.full_k[st], ph);
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
    if (lane == 0) mbar_arrive(&ring.empty_k[st]);
    // s[4j + c]: row g (c < 2) or g + 8, local key t*TK + 8j + 2tq + (c & 1)
    const int key0 = t * TK + 2 * tq;
    if (general) {
#pragma unroll
      for (int k = 0; k < kS; ++k)
#ifdef FI_USER_VARIANT
        s[k] = user_logit(p, it, s[k], (k & 2) ? head_b : head_a,
                          (k & 2) ? utok_b : utok_a,
                          it.kv_start + key0 + (k >> 2) * 8 + (k & 1));
#else
        s[k] = general_logit(p, s[k], (k & 2) ? slope_b : slope_a,
                             (k & 2) ? tok_b : tok_a,
                             it.kv_start + key0 + (k >> 2) * 8 + (k & 1));
#endif
    }
    // whether the work mask cuts this warpgroup's rows of the tile
    const bool masked = walk.classes(i) >> (2 * wg) & kMapDrop;
    const bool full =
        !FI_USER_MASK && !masked && (t + 1) * TK <= it.span &&
        !(p.causal && it.kv_start + (t + 1) * TK - 1 > tok_lo) &&
        !(p.window_left >= 0 && it.kv_start + t * TK < tok_hi - p.window_left);
    if (!full) {  // an edge: test each (row, key), the mask's bytes if cut
#pragma unroll
      for (int k = 0; k < kS; ++k)
        if (!(masked ? keep(p, it, (k & 2) ? rb : ra, (k & 2) ? tok_b : tok_a,
                            key0 + (k >> 2) * 8 + (k & 1))
                     : in_span(p, it, (k & 2) ? tok_b : tok_a,
                               key0 + (k >> 2) * 8 + (k & 1)))
#if FI_USER_MASK
            || !user_keep(p, it, (k & 2) ? head_b : head_a,
                          (k & 2) ? utok_b : utok_a,
                          key0 + (k >> 2) * 8 + (k & 1))
#endif
        )
          s[k] = -CUDART_INF_F;
    }
    const float c = general ? 1.f : p.scale_log2;  // raw logit -> base 2
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kS; k += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[k], s[k + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[k + 2], s[k + 3]));
    }
    mx_a = fmaxf(m_a, ceilf(quad_max(mx_a) * c));  // an integer: see pow2
    mx_b = fmaxf(m_b, ceilf(quad_max(mx_b) * c));
    const float sa = (mx_a == -CUDART_INF_F) ? 0.f : mx_a;
    const float sb = (mx_b == -CUDART_INF_F) ? 0.f : mx_b;
    const float alpha_a = (m_a == -CUDART_INF_F) ? 0.f : pow2(m_a - sa);
    const float alpha_b = (m_b == -CUDART_INF_F) ? 0.f : pow2(m_b - sb);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int k = 0; k < kS; k += 4) {  // exp2(-inf) = 0 for masked keys
      s[k] = exp2_ftz(fmaf(s[k], c, -sa));
      s[k + 1] = exp2_ftz(fmaf(s[k + 1], c, -sa));
      s[k + 2] = exp2_ftz(fmaf(s[k + 2], c, -sb));
      s[k + 3] = exp2_ftz(fmaf(s[k + 3], c, -sb));
      sum_a += s[k] + s[k + 1];
      sum_b += s[k + 2] + s[k + 3];
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's share of l
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int k = 0; k < kO; k += 4) {
      o[k] *= alpha_a;
      o[k + 1] *= alpha_a;
      o[k + 2] *= alpha_b;
      o[k + 3] *= alpha_b;
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
    mbar_wait(&ring.full_v[st], ph);
    if (!KV8 && t == tail)
      zero_tail_rows<TK, kVB>(vs, it.span - t * TK, wtid, 1 + wg);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<DV>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, TK * 128, 1024),
                   1);
    wg_commit();
    wg_wait<0>();
    hold<kO>(o);
    hold<TK / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(&ring.empty_v[st]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= p.tile_q) continue;
    const bool ok = row_ok(p, it, r);
    float lse;
    const float f = finish_row(p, half ? m_b : m_a, half ? l_b : l_a, &lse);
    const size_t orow = (size_t(w) * p.kvh + h) * p.tile_q + r;
    if (p.q_f32) {
      float* out = static_cast<float*>(p.o) + orow * p.dv + 2 * tq;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        if (8 * j + 2 * tq < p.dv)
          *reinterpret_cast<float2*>(out + j * 8) =
              ok ? make_float2(o[4 * j + 2 * half] * f,
                               o[4 * j + 2 * half + 1] * f)
                 : make_float2(0.f, 0.f);
    } else {
      bf16* out = static_cast<bf16*>(p.o) + orow * p.dv + 2 * tq;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        if (8 * j + 2 * tq < p.dv)
          *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
              ok ? __floats2bfloat162_rn(o[4 * j + 2 * half] * f,
                                         o[4 * j + 2 * half + 1] * f)
                 : __floats2bfloat162_rn(0.f, 0.f);
    }
    if (tq == 0) p.lse[orow] = ok ? lse : -CUDART_INF_F;
  }
}

// ------------------------------------------------------- decode: swap-AB

// Shared memory of the decode kernel: Q [d blocks][NR rows][128 B], P^T
// [TK / 64 key blocks][NR rows][128 B], the row max / sum exchange
// [2][4 warps][NR] floats, `s` bf16 stages of K [d blocks][TK][128 B] and V
// [dv blocks][TK][128 B], with an 8-bit cache `s8` byte stages of K [TK][d]
// and V [TK][dv], the barriers, and 1024 bytes of slack to align the
// swizzle atoms (and, with a tile map, the CTA's tile classes).
size_t dec_smem(int d, int dv, int dvp, int tk, int nr, int s, int s8) {
  const int qb = (d + 63) / 64, vb = dvp / 64;
  return 1024 + size_t(qb) * nr * 128 + size_t(tk / 64) * nr * 128 +
         round1024(2 * 4 * nr * 4) + size_t(s) * (qb + vb) * tk * 128 +
         size_t(s8) * (round1024(tk * d) + round1024(tk * dv)) +
         8 * (4 * s + 4 * s8);
}

// Decode tiles (tile_q 8, 16 or 32 rows = NR): swap-AB. The keys are
// wgmma's M (64 a block) and the tile's rows its N, so a tile of 8 rows
// runs no 64-row product: S^T = K.Q^T with K (A) and Q (B) from swizzled
// shared memory; the row max crosses the four warps through shared memory;
// P^T goes to shared memory as bf16 and is the B operand of O^T = V^T.P^T,
// whose A operand is V read MN-major. One consumer warpgroup; the producer
// warpgroup of the row-block kernel (TMA), and for 8-bit caches two, one
// converting K's byte stages into bf16 stages and one V's.
// Launch bounds of three warpgroups (it runs two): ptxas then sizes the
// kernel below both setmaxnreg targets.
template <int DV, int TK, int NR, bool KV8>
__global__ void __launch_bounds__(384, 1)
    paged_dec_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kMB = TK / 64;   // 64-key blocks of S^T
  constexpr int kVB = DV / 64;   // 64-column blocks of O^T
  constexpr int kN = NR / 2;     // accumulators a thread a block
  constexpr int kR = NR / 4;     // tile rows a thread holds: 8j + 2tq + e
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_last, s_walk;  // last real row; tiles the CTA walks
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int d = p.d, dv = p.dv, qb = (d + 63) / 64;
  const int S = p.stages, S8 = p.byte_stages;
  const int k_stage = qb * TK * 128, v_stage = kVB * TK * 128;
  unsigned char* sQ = base;
  unsigned char* sP = sQ + qb * NR * 128;
  float* red = reinterpret_cast<float*>(sP + kMB * NR * 128);
  unsigned char* sK = reinterpret_cast<unsigned char*>(red) +
                      round1024(2 * 4 * NR * 4);
  const int kb_stage = round1024(TK * d), vb_stage = round1024(TK * dv);
  unsigned char* sB = sK + S * (k_stage + v_stage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sB + S8 * (kb_stage + vb_stage));
  const Ring ring = make_ring(sK, k_stage, v_stage, S, bars);
  const Ring bytes = make_ring(sB, kb_stage, vb_stage, S8, bars + 4 * S);

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid & 127) >> 5;
  const Item it = load_item(p, w);
  if (it.span <= 0) {
    write_identity(p, w, h, 0, NR, tid, blockDim.x);
    return;
  }
  if (tid == 0) s_last = -1;
  __syncthreads();
  if (tid < NR && row_ok(p, it, tid)) atomicMax(&s_last, tid);
  __syncthreads();
  const int last = s_last;
  if (last < 0) {  // padding rows only
    write_identity(p, w, h, 0, NR, tid, blockDim.x);
    return;
  }
  int lo, hi;
  key_range(p, it, 0, last, lo, hi);
  const int t0 = lo / TK, t1 = hi > lo ? (hi + TK - 1) / TK : t0;
  // a tile's class without a map: the work mask cuts every tile
  const int mask_cls = p.work_mask ? kMapKeep | kMapDrop : kMapKeep;
  if (tid == 0) {
    s_walk = walk_length(p, w, t0, t1);
    // empty: one arrival a consumer warp (a converter warp, byte ring)
    init_ring(ring, 1, 4);
    init_ring(bytes, kGather ? 128 : 1, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk walk = cta_walk(p, w, t0, mask_cls, &s_walk);
  if (p.walk_ws != nullptr && walk.n == 0) {  // the mask keeps no key here
    write_identity(p, w, h, 0, NR, tid, blockDim.x);
    return;
  }

  if (tid >= 128) {  // ---- producer warpgroups: 8-bit, one for K, one for V
    if (KV8)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 144;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::: "memory");
    produce<TK, KV8, 4>(p, it, h, &tm_k, &tm_v, ring, bytes, qb, kVB, walk,
                        KV8 ? 1 + ((tid - 128) >> 7) : 0, tid & 127);
    return;
  }

  // ---- the consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int g = lane >> 2, tq = lane & 3;
  for (int i = tid; i < NR * qb * 8; i += 128) {  // Q as bf16, 0 past d
    const int r = i / (qb * 8), cb = (i / 8) % qb, ch = i % 8;
    const int col = cb * 64 + ch * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.tile_q && it.qo_start + r < p.q_rows && col < d) {
      const size_t off = (size_t(h) * p.q_rows + it.qo_start + r) * d + col;
#if defined(FI_USER_VARIANT) && FI_USER_HAS_Q
      float f[8];
      load_q8(p, off, f);
      x = user_q_pack8(f, row_head(p, it, h, r), p.user);
#else
      if (p.q_f32) {
        const float4* src =
            reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + off);
        const float4 a = src[0], b = src[1];
        x = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                       pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      } else {
        x = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.q) + off);
      }
#endif
    }
    *reinterpret_cast<uint4*>(sQ + cb * NR * 128 + sw128(r, ch)) = x;
  }
  fence_async_smem();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  int tok[kR];
  float slope[kR];
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    tok[jr] = q_tok(p, it, 8 * (jr >> 1) + 2 * tq + (jr & 1));
    slope[jr] = alibi_slope(p, it, h, 8 * (jr >> 1) + 2 * tq + (jr & 1));
  }
  const int tok_lo = q_tok(p, it, 0), tok_hi = q_tok(p, it, last);
#ifdef FI_USER_VARIANT
  const bool general = FI_USER_HAS_LOGITS || !(p.scale_log2 > 0.f);
  int head[kR];
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    head[jr] = row_head(p, it, h, 8 * (jr >> 1) + 2 * tq + (jr & 1));
    tok[jr] = min(tok[jr], tok_hi);  // rows past the last real one
  }
#else
  const bool general =
      p.soft_cap > 0.f || p.alibi != nullptr || !(p.scale_log2 > 0.f);
#endif
  const float c = general ? 1.f : p.scale_log2;  // raw logit -> base 2
  const int tail = it.span % TK ? it.span / TK : -1;
  float m[kR], l[kR], o[kVB][kN];
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    m[jr] = -CUDART_INF_F;
    l[jr] = 0.f;
  }
#pragma unroll
  for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
    for (int k = 0; k < kN; ++k) o[vb][k] = 0.f;

  for (int i = 0; i < walk.n; ++i) {
    const int t = walk.tile(i), st = i % S, ph = (i / S) & 1;
    const unsigned char* ks = ring.k + st * k_stage;
    unsigned char* vs = ring.v + st * v_stage;
    // S^T = K.Q^T: s[mb][4j + c] is key mb*64 + 16 warp + g (+ 8 for
    // c >= 2) against tile row 8j + 2tq + (c & 1)
    float s[kMB][kN];
    mbar_wait(&ring.full_k[st], ph);
    wg_fence();
    for (int kk = 0; kk < d / 16; ++kk) {
      const uint64_t db =
          sw128_desc(sQ + (kk >> 2) * NR * 128 + (kk & 3) * 32, 16, 1024);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
        wgmma_ss<NR>(s[mb],
                     sw128_desc(ks + (kk >> 2) * TK * 128 + mb * 64 * 128 +
                                    (kk & 3) * 32, 16, 1024),
                     db, kk > 0);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) hold<kN>(s[mb]);
    if (lane == 0) mbar_arrive(&ring.empty_k[st]);

    // s[mb][k]: key t*TK + mb*64 + 16 warp + g (+ 8 for bit 1 of k), tile
    // row 8 (k >> 2) + 2tq + (k & 1), whose token and slope are jr's
    if (general) {
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const int jr = 2 * (k >> 2) + (k & 1);
#ifdef FI_USER_VARIANT
          s[mb][k] = user_logit(
              p, it, s[mb][k], head[jr], tok[jr],
              it.kv_start + t * TK + mb * 64 + warp * 16 + g +
                  ((k >> 1) & 1) * 8);
#else
          s[mb][k] = general_logit(
              p, s[mb][k], slope[jr], tok[jr],
              it.kv_start + t * TK + mb * 64 + warp * 16 + g +
                  ((k >> 1) & 1) * 8);
#endif
        }
    }
    // whether the work mask cuts the tile
    const bool masked = walk.classes(i) & kMapDrop;
    const bool full =
        !FI_USER_MASK && !masked && (t + 1) * TK <= it.span &&
        !(p.causal && it.kv_start + (t + 1) * TK - 1 > tok_lo) &&
        !(p.window_left >= 0 && it.kv_start + t * TK < tok_hi - p.window_left);
    if (!full) {
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const int key = t * TK + mb * 64 + warp * 16 + g + ((k >> 1) & 1) * 8;
          if (!(masked ? keep(p, it, 8 * (k >> 2) + 2 * tq + (k & 1),
                              tok[2 * (k >> 2) + (k & 1)], key)
                       : in_span(p, it, tok[2 * (k >> 2) + (k & 1)], key))
#if FI_USER_MASK
              || !user_keep(p, it, head[2 * (k >> 2) + (k & 1)],
                            tok[2 * (k >> 2) + (k & 1)], key)
#endif
          )
            s[mb][k] = -CUDART_INF_F;
        }
    }
    // the row max: this thread's keys, the warp's 16 (lanes g), the four warps
#pragma unroll
    for (int jr = 0; jr < kR; ++jr) {
      float x = -CUDART_INF_F;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
        x = fmaxf(x, fmaxf(s[mb][4 * (jr >> 1) + (jr & 1)],
                           s[mb][4 * (jr >> 1) + (jr & 1) + 2]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
      if (g == 0) red[warp * NR + 8 * (jr >> 1) + 2 * tq + (jr & 1)] = x;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    float alpha[kR], ms[kR];
#pragma unroll
    for (int jr = 0; jr < kR; ++jr) {
      const int row = 8 * (jr >> 1) + 2 * tq + (jr & 1);
      const float x = fmaxf(fmaxf(red[row], red[NR + row]),
                            fmaxf(red[2 * NR + row], red[3 * NR + row]));
      const float m_new = fmaxf(m[jr], ceilf(x * c));  // see pow2
      ms[jr] = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      alpha[jr] = (m[jr] == -CUDART_INF_F) ? 0.f : pow2(m[jr] - ms[jr]);
      m[jr] = m_new;
      l[jr] *= alpha[jr];
    }
    // P = 2^(s c - m), rounded to bf16 into P^T [key block][row][key]
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int jr = 2 * (k >> 2) + (k & 1), hk = (k >> 1) & 1;
        const float e = exp2_ftz(fmaf(s[mb][k], c, -ms[jr]));
        l[jr] += e;
        const int row = 8 * (k >> 2) + 2 * tq + (k & 1);
        *reinterpret_cast<bf16*>(sP + mb * NR * 128 + row * 128 +
                                 (((warp * 2 + hk) ^ (row & 7)) << 4) + 2 * g) =
            __float2bfloat16(e);
      }
    // O^T = alpha O^T + V^T.P^T: o[vb][4j + c] is column vb*64 + 16 warp +
    // g (+ 8 for c >= 2) of tile row 8j + 2tq + (c & 1)
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int k = 0; k < kN; ++k) o[vb][k] *= alpha[2 * (k >> 2) + (k & 1)];
    mbar_wait(&ring.full_v[st], ph);
    if (!KV8 && t == tail) zero_tail_rows<TK, kVB>(vs, it.span - t * TK, tid, 1);
    fence_async_smem();  // P^T visible to wgmma
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    wg_fence();
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_ss_ta<NR>(o[vb],
                        sw128_desc(vs + vb * TK * 128 + kk * 16 * 128,
                                   TK * 128, 1024),
                        sw128_desc(sP + (kk >> 2) * NR * 128 + (kk & 3) * 32,
                                   16, 1024),
                        1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb) hold<kN>(o[vb]);
    if (lane == 0) mbar_arrive(&ring.empty_v[st]);
  }

  // l: the thread's share, the warp's, the four warps'
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    float x = l[jr];
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (g == 0) red[4 * NR + warp * NR + 8 * (jr >> 1) + 2 * tq + (jr & 1)] = x;
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    const int row = 8 * (jr >> 1) + 2 * tq + (jr & 1);
    const float* lr = red + 4 * NR + row;
    const bool ok = row_ok(p, it, row);
    float lse;
    const float f = finish_row(p, m[jr], lr[0] + lr[NR] + lr[2 * NR] + lr[3 * NR],
                               &lse);
    const size_t orow = (size_t(w) * p.kvh + h) * p.tile_q + row;
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int col = vb * 64 + warp * 16 + g + 8 * hk;
        if (col >= dv) continue;
        const float x = ok ? o[vb][4 * (jr >> 1) + 2 * hk + (jr & 1)] * f : 0.f;
        if (p.q_f32)
          static_cast<float*>(p.o)[orow * dv + col] = x;
        else
          static_cast<bf16*>(p.o)[orow * dv + col] = __float2bfloat16(x);
      }
    if (warp == 0 && g == 0) p.lse[orow] = ok ? lse : -CUDART_INF_F;
  }
}

// ------------------------------------------------------------- CUDA cores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

template <int ROWS>
size_t f32_smem_bytes(int d, int dv) {
  return (size_t(ROWS) * d + size_t(kTileF32) * (d + 1) +
          size_t(kTileF32) * dv + size_t(ROWS) * kTileF32 + 3 * ROWS) *
         sizeof(float);
}

// Gathers local keys [k0, k0 + 64) of head h's `width` columns into
// shared memory as f32 (row stride ld); keys past the span become 0.
template <typename KT>
__device__ __forceinline__ void load_rows_f32(const Params& p, const Item& it,
                                              const KT* cache, int h, int k0,
                                              int width, int ld, float* dst) {
  constexpr int kVec = 16 / sizeof(KT);
  const int vpr = width / kVec;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kTileF32 * vpr; i += kThreads) {
    const int j = i / vpr, c0 = (i % vpr) * kVec, lk = k0 + j;
    float f[kVec];
    if (lk < it.span) {
      const int page =
          p.kv_indices[it.page0 + lk / p.page_size] + p.kv_indices_offset;
      const int slot = lk % p.page_size;
      const size_t off =
          p.layout_hnd
              ? ((size_t(page) * p.kvh + h) * p.page_size + slot) * width + c0
              : ((size_t(page) * p.page_size + slot) * p.kvh + h) * width + c0;
      const uint4 x = *reinterpret_cast<const uint4*>(cache + off);
      const KT* e = reinterpret_cast<const KT*>(&x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = to_f32(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) dst[j * ld + c0 + k] = f[k];
  }
}

// f32 q with an f32 or int8 cache: a CTA of ROWS rows; QK with a thread per
// (key, ROWS/2 rows), the softmax a warp per ROWS/4 rows, P.V with a
// thread per output column (two for dv > 128).
template <typename KT, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_f32_kernel(const Params p) {
  static_assert(ROWS % 8 == 0, "two row groups of QK, four softmax warps");
  constexpr int RPT = ROWS / 2, RPW = ROWS / 4;
  extern __shared__ float smem_f[];
  __shared__ int s_last;
  const int d = p.d, dv = p.dv;
  float* q_s = smem_f;                     // [ROWS][d]
  float* k_s = q_s + ROWS * d;             // [64][d + 1]
  float* v_s = k_s + kTileF32 * (d + 1);   // [64][dv]
  float* p_s = v_s + kTileF32 * dv;        // [ROWS][64]
  float* alpha_s = p_s + ROWS * kTileF32;  // [ROWS]
  float* l_s = alpha_s + ROWS;
  float* m_s = l_s + ROWS;

  const int w = blockIdx.x, h = blockIdx.y, row0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Item it = load_item(p, w);
  if (it.span <= 0) {
    write_identity(p, w, h, row0, row0 + ROWS, tid, kThreads);
    return;
  }
  if (tid == 0) s_last = -1;
  __syncthreads();
  if (tid < ROWS && row_ok(p, it, row0 + tid)) atomicMax(&s_last, row0 + tid);
  __syncthreads();
  const int last = s_last;
  if (last < 0) {
    write_identity(p, w, h, row0, row0 + ROWS, tid, kThreads);
    return;
  }
  int lo, hi;
  key_range(p, it, row0, last, lo, hi);

  const float* q = static_cast<const float*>(p.q) +
                   (size_t(h) * p.q_rows + it.qo_start + row0) * d;
  for (int i = tid; i < ROWS * d; i += kThreads) {
    const int r = row0 + i / d;
#if defined(FI_USER_VARIANT) && FI_USER_HAS_Q
    q_s[i] = (r < p.tile_q && it.qo_start + r < p.q_rows)
                 ? user_q(q[i], row_head(p, it, h, r), p.user)
                 : 0.f;
#else
    q_s[i] = (r < p.tile_q && it.qo_start + r < p.q_rows) ? q[i] : 0.f;
#endif
  }
  const int jq = tid % kTileF32, rg = tid / kTileF32;
  int tok[RPT];
  float slope[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    tok[r] = q_tok(p, it, row0 + rg * RPT + r);
    slope[r] = alibi_slope(p, it, h, row0 + rg * RPT + r);
  }

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

  const KT* kc = static_cast<const KT*>(p.k);
  const KT* vc = static_cast<const KT*>(p.v);
  const int mask_cls = p.work_mask ? kMapKeep | kMapDrop : kMapKeep;
  for (int k0 = lo / kTileF32 * kTileF32; k0 < hi; k0 += kTileF32) {
    // the tile map's class of the tile (its 64 keys are one tile of the map):
    // skipped where the mask keeps no key, the mask unread where it keeps all
    const int cls = p.tile_map ? map_class(p, w, row0 / kMapRows,
                                           k0 / kTileF32, 1)
                               : mask_cls;
    if (!(cls & kMapKeep)) continue;
    const bool masked = cls & kMapDrop;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows_f32<KT>(p, it, kc, h, k0, d, d + 1, k_s);
    load_rows_f32<KT>(p, it, vc, h, k0, dv, dv, v_s);
    __syncthreads();

    float s[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) s[r] = 0.f;
    const float* krow = k_s + jq * (d + 1);
    for (int c = 0; c < d; c += 4) {
      const float k_0 = krow[c], k_1 = krow[c + 1], k_2 = krow[c + 2],
                  k_3 = krow[c + 3];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (rg * RPT + r) * d + c);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }
    const int lk = k0 + jq;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#ifdef FI_USER_VARIANT
      const int hr = row_head(p, it, h, row0 + rg * RPT + r);
      const int ut = min(tok[r], q_tok(p, it, last));
      const float x = user_logit(p, it, s[r], hr, ut, it.kv_start + lk);
      p_s[(rg * RPT + r) * kTileF32 + jq] =
          (masked ? keep(p, it, row0 + rg * RPT + r, tok[r], lk)
                  : in_span(p, it, tok[r], lk)) &&
                  user_keep(p, it, hr, ut, lk)
              ? x
              : -CUDART_INF_F;
#else
      const float x =
          general_logit(p, s[r], slope[r], tok[r], it.kv_start + lk);
      p_s[(rg * RPT + r) * kTileF32 + jq] =
          (masked ? keep(p, it, row0 + rg * RPT + r, tok[r], lk)
                  : in_span(p, it, tok[r], lk))
              ? x
              : -CUDART_INF_F;
#endif
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      float* pr = p_s + row * kTileF32;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_new = fmaxf(m_reg[r], warp_max(fmaxf(x0, x1)));
      const float m_safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float e0 = (x0 == -CUDART_INF_F) ? 0.f : exp2f(x0 - m_safe);
      const float e1 = (x1 == -CUDART_INF_F) ? 0.f : exp2f(x1 - m_safe);
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
      for (int j = 0; j < kTileF32; j += 4) {
        const float v0 = v_s[j * dv + col], v1 = v_s[(j + 1) * dv + col];
        const float v2 = v_s[(j + 2) * dv + col], v3 = v_s[(j + 3) * dv + col];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 pv =
              *reinterpret_cast<const float4*>(p_s + r * kTileF32 + j);
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
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    if (row >= p.tile_q) break;
    const bool ok = row_ok(p, it, row);
    float lse;
    const float f = finish_row(p, m_s[r], l_s[r], &lse);
    const size_t orow = (size_t(w) * p.kvh + h) * p.tile_q + row;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int col = tid + ci * kThreads;
      if (col < dv) o[orow * dv + col] = ok ? acc[ci][r] * f : 0.f;
    }
    if (tid == 0) p.lse[orow] = ok ? lse : -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------- launch

template <typename KT, int ROWS>
cudaError_t launch_f32_at(const Params& p, cudaStream_t s) {
  auto kernel = paged_f32_kernel<KT, ROWS>;
  const size_t bytes = f32_smem_bytes<ROWS>(p.d, p.dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.T, p.kvh, (p.tile_q + ROWS - 1) / ROWS);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  return p.tile_q >= 32 ? launch_f32_at<KT, 32>(p, s)
                        : launch_f32_at<KT, 8>(p, s);
}

// A 4-D map over a paged cache: dims (width, head, slot, page) for NHD or
// (width, slot, head, page) for HND. bf16: boxes of 64 columns x box_rows
// slots, 128-byte swizzle, zero fill past the width; 8-bit: boxes of the
// whole row's bytes x box_rows slots, unswizzled.
bool cache_map(CUtensorMap* map, const void* ptr, bool kv8, int width,
               int kvh, int ps, int pages, int hnd, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = cuuint64_t(width) * (kv8 ? 1 : 2);
  const cuuint64_t dims[4] = {cuuint64_t(width),
                              cuuint64_t(hnd ? ps : kvh),
                              cuuint64_t(hnd ? kvh : ps), cuuint64_t(pages)};
  const cuuint64_t strides[3] = {row, row * (hnd ? ps : kvh),
                                 row * ps * kvh};
  const cuuint32_t box[4] = {cuuint32_t(kv8 ? width : 64),
                             cuuint32_t(hnd ? box_rows : 1),
                             cuuint32_t(hnd ? 1 : box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                kv8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                kv8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The K and V maps of a tensor-core launch with TK-key tiles: boxes of
// gcd(page, TK) rows (p.box_rows), a multiple of 8 tokens as the TMA build
// takes pages. The gather build leaves the maps unused (zero), and
// box_rows 8, which box_page reads harmlessly.
bool cache_maps(CUtensorMap* tm_k, CUtensorMap* tm_v, Params& p, bool kv8,
                int tk, int pages) {
  if (kGather) {
    p.box_rows = 8;
    return true;
  }
  p.box_rows = gcd(p.page_size, tk);
  return cache_map(tm_k, p.k, kv8, p.d, p.kvh, p.page_size,
                   pages, p.layout_hnd, p.box_rows) &&
         cache_map(tm_v, p.v, kv8, p.dv, p.kvh, p.page_size,
                   pages, p.layout_hnd, p.box_rows);
}

// The walks' launch before the attention's (with a map): nz CTAs an item
// of `blocks` 64-row blocks each, tiles of tk keys, into the workspace.
cudaError_t launch_walks(Params& p, int tk, int nz, int blocks,
                         cudaStream_t s) {
  if (p.tile_map == nullptr) {
    p.walk_ws = nullptr;
    return cudaSuccess;
  }
  p.walk_ctas = p.T * nz;
  if (p.walk_ws == nullptr ||
      size_t(p.walk_ctas) * (1 + p.map_nt) > p.walk_ws_len)
    return cudaErrorInvalidValue;
  paged_walk_kernel<<<(p.walk_ctas + 3) / 4, 128, 0, s>>>(p, tk, nz, blocks);
  return cudaGetLastError();
}

template <int DV, int TK, bool KV8>
cudaError_t launch_tc_at(Params p, int pages, cudaStream_t s) {
  const TcGeo g = tc_geo(p.d, p.dv, DV, KV8);
  if (g.smem > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  p.stages = g.stages;
  p.byte_stages = g.byte_stages;
  CUtensorMap tm_k{}, tm_v{};
  if (!cache_maps(&tm_k, &tm_v, p, KV8, TK, pages)) return cudaErrorInvalidValue;
  auto kernel = paged_tc_kernel<DV, TK, KV8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(g.smem));
  if (err == cudaSuccess)
    err = launch_walks(p, TK, (p.tile_q + 2 * kWgRows - 1) / (2 * kWgRows),
                       2, s);
  if (err != cudaSuccess) return err;
  dim3 grid(p.T, p.kvh, (p.tile_q + 2 * kWgRows - 1) / (2 * kWgRows));
  kernel<<<grid, 384, g.smem, s>>>(tm_k, tm_v, p);
  return cudaGetLastError();
}

template <int DV, int TK, int NR, bool KV8>
cudaError_t launch_dec_at(Params p, int pages, cudaStream_t s) {
  // bf16: as many K/V stages as fit, up to six; 8-bit: two bf16 stages,
  // then as many byte stages as fit, up to six
  int stages = 2, byte_stages = KV8 ? 1 : 0;
  int& grow = KV8 ? byte_stages : stages;
  while (grow < 6 && dec_smem(p.d, p.dv, DV, TK, NR, stages + !KV8,
                              byte_stages + KV8) <= kSmemLimit)
    ++grow;
  const size_t bytes = dec_smem(p.d, p.dv, DV, TK, NR, stages, byte_stages);
  if (bytes > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  p.stages = stages;
  p.byte_stages = byte_stages;
  CUtensorMap tm_k{}, tm_v{};
  if (!cache_maps(&tm_k, &tm_v, p, KV8, TK, pages)) return cudaErrorInvalidValue;
  auto kernel = paged_dec_kernel<DV, TK, NR, KV8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) err = launch_walks(p, TK, 1, 1, s);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.T, p.kvh, 1), KV8 ? 384 : 256, bytes, s>>>(tm_k, tm_v, p);
  return cudaGetLastError();
}

template <int DV, int TK, int NR>
cudaError_t launch_dec_kv(const Params& p, int kv_dtype, int pages,
                          cudaStream_t s) {
  return kv_dtype == kBF16 ? launch_dec_at<DV, TK, NR, false>(p, pages, s)
                           : launch_dec_at<DV, TK, NR, true>(p, pages, s);
}

// Decode tiles (8, 16 or 32 rows) take the swap-AB kernel, larger tiles
// the row-block kernel; 128 keys a tile up to 128 V columns, else 64.
template <int DV>
cudaError_t launch_tc_dv(const Params& p, int kv_dtype, int pages,
                         cudaStream_t s) {
  constexpr int TK = DV <= 128 ? 128 : 64;
  switch (p.tile_q) {
    case 8: return launch_dec_kv<DV, TK, 8>(p, kv_dtype, pages, s);
    case 16: return launch_dec_kv<DV, TK, 16>(p, kv_dtype, pages, s);
    case 32: return launch_dec_kv<DV, TK, 32>(p, kv_dtype, pages, s);
    default: break;
  }
  const bool kv8 = kv_dtype != kBF16;
  if constexpr (DV <= 128) {
    if (tc_geo(p.d, p.dv, DV, kv8).tk == 128)
      return kv8 ? launch_tc_at<DV, 128, true>(p, pages, s)
                 : launch_tc_at<DV, 128, false>(p, pages, s);
  }
  return kv8 ? launch_tc_at<DV, 64, true>(p, pages, s)
             : launch_tc_at<DV, 64, false>(p, pages, s);
}

cudaError_t launch_tc(const Params& p, int kv_dtype, int pages,
                      cudaStream_t s) {
  switch ((p.dv + 63) / 64) {  // V columns padded to 64-column blocks
    case 1: return launch_tc_dv<64>(p, kv_dtype, pages, s);
    case 2: return launch_tc_dv<128>(p, kv_dtype, pages, s);
    case 3: return launch_tc_dv<192>(p, kv_dtype, pages, s);
    case 4: return launch_tc_dv<256>(p, kv_dtype, pages, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [kvh, q_rows, d] (bf16 or f32); k [.., d] and v [.., dv] paged caches
// of `pages` pages; row_valid [q_rows] int32 or null; work_mask uint8 [T,
// tile_q, mask_chunk] or null; tile_map uint8 [T, ceil(tile_q / 64),
// ceil(mask_chunk / 64)] (a work mask's) or null, with walk_ws, int32
// scratch of walk_ws_len >= T * ceil(tile_q / 64) * (1 + ceil(mask_chunk /
// 64)) elements for the CTAs' walks; alibi f32 [kvh * group] or null. bf16
// q with a bf16,
// e4m3 or int8 cache, and f32 q with an e4m3 cache, run on the tensor
// cores (16-byte-aligned caches; pages of a multiple of 8 tokens in the
// TMA build, of any size in the gather build); f32 q with an f32 or int8
// cache on the CUDA cores.
extern "C" int fi_paged_attention(
    const void* q, const void* k, const void* v, const int* plan,
    const int* kv_indices, const int* row_valid,
    const unsigned char* work_mask, const unsigned char* tile_map,
    int* walk_ws, long long walk_ws_len, const float* alibi, void* o,
    float* lse,
    int T, int kvh, int q_rows, int tile_q, int d, int dv, int page_size,
    int pages, int layout_hnd, int kv_indices_offset, int group,
    int mask_chunk, float sm_scale, float v_scale, int causal,
    int window_left, float soft_cap, int q_dtype, int kv_dtype,
    void* stream
#ifdef FI_USER_VARIANT
    , const UserParams* user
#endif
    ) {
  if (d <= 0 || d > 256 || d % 16 != 0 || dv <= 0 || dv > 256 ||
      dv % 16 != 0 || tile_q <= 0 || tile_q % 8 != 0 || T <= 0 ||
      page_size <= 0 || group <= 0 ||
      (work_mask != nullptr && mask_chunk <= 0) ||
      (tile_map != nullptr && work_mask == nullptr))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.plan = plan; p.kv_indices = kv_indices;
  p.row_valid = row_valid; p.work_mask = work_mask; p.alibi = alibi;
  p.mask_chunk = mask_chunk; p.o = o; p.lse = lse;
  p.tile_map = tile_map;
  p.map_rb = (tile_q + kMapRows - 1) / kMapRows;
  p.map_nt = (mask_chunk + kMapKeys - 1) / kMapKeys;
  p.walk_ws = walk_ws;
  p.walk_ws_len = walk_ws_len > 0 ? size_t(walk_ws_len) : 0;
  p.walk_ctas = 0;
  p.T = T; p.kvh = kvh; p.q_rows = q_rows; p.tile_q = tile_q; p.d = d;
  p.dv = dv; p.page_size = page_size; p.layout_hnd = layout_hnd;
  p.kv_indices_offset = kv_indices_offset; p.group = group;
  p.causal = causal; p.window_left = window_left;
  p.q_f32 = q_dtype == kF32; p.kv_i8 = kv_dtype == kI8;
  p.box_rows = 0; p.stages = 0; p.byte_stages = 0;
  p.scale_log2 = float(double(sm_scale) * 1.4426950408889634);
  p.sm_scale = sm_scale; p.soft_cap = soft_cap; p.v_scale = v_scale;
#ifdef FI_USER_VARIANT
  p.user = *user;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tensor_cores =
      (q_dtype == kBF16 && (kv_dtype == kBF16 || kv_dtype == kE4M3 ||
                            kv_dtype == kI8)) ||
      (q_dtype == kF32 && kv_dtype == kE4M3);
  if (tensor_cores) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
    if ((!kGather && page_size % 8 != 0) || (addr & 15))
      return int(cudaErrorInvalidValue);
    return int(launch_tc(p, kv_dtype, pages, s));
  }
  if (q_dtype != kF32) return int(cudaErrorInvalidValue);
  if (kv_dtype == kF32) return int(launch_f32<float>(p, s));
  if (kv_dtype == kI8) return int(launch_f32<int8_t>(p, s));
  return int(cudaErrorInvalidValue);
}
