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
// bf16 for e4m3 caches. P is taken against the running base-2 max, as the
// TPU kernel and the plain version take it (the plain version against the
// row's max: a tile that raises the max rounds P a bf16 step apart on some
// keys). The wrapper folds the 8-bit scales into sm_scale and v_scale and
// prescales q_pe when kpe_scale != ckv_scale.
//
// What bounds it on the H100: at decode the bytes (the ckv and kpe of every
// key read once, 1152 B a token in bf16, shared by all 16 heads of a
// token: 30 operations a byte at 16 rows), at prefill the operations (2 *
// (2 d_ckv + d_kpe) a (row, key) pair, 2176). Three routes, chosen by the C
// entry from q's dtype, tile_q and the widths (`fi_mla_route` reports it):
// - Decode tiles (bf16 q, tile_q 8/16/32, DeepSeek's 512/64): swap-AB on
//   wgmma, a CTA per work item. S^T = K.Q^T with 64 keys as wgmma's M and
//   the tile's rows as its N, a depth of 576 (36 k-steps); the softmax over
//   keys in registers, the row max crossing the four warps through shared
//   memory; P^T (bf16) in shared memory is the B operand of O^T = V^T.P^T,
//   whose A operand is the stage's ckv blocks read MN-major (8 blocks of 64
//   columns, O^T's 512 x N accumulator in the one consumer warpgroup). So a
//   16-row tile costs tensor-core time for 16 rows, not 64.
// - Row tiles (bf16 q, tile_q a multiple of 64): a CTA per (item, 64 rows),
//   two consumer warpgroups. The 64 x 512 O accumulator (256 registers a
//   thread in one warpgroup) is split into two halves of 256 columns.
//   Each warpgroup computes S = Q.K^T for half of the 64-key tile (m64n32,
//   36 k-steps), the two exchange row maxima through shared memory and
//   write their halves of P (bf16), and each runs O += P.V over the whole
//   tile on its half of the columns (m64n256k16, V MN-major). Shared
//   memory: Q 64 x 576 bf16 (73,728 B), two 64-key stages (147,456 B), P
//   (8,192 B): 229,376 of the 232,448 a block may use. 8-bit caches trade
//   a bf16 stage for two byte stages (2 x 36,864 B): 32-key tiles with two
//   of each measured 2% slower at tile_q 128. At 16 heads a 64-row tile
//   holds 4 tokens: ~121 operations a key byte, so the key tiles' reads
//   (from L2: one item's keys serve all its row tiles) bound it more than
//   the tensor cores.
// - Everything else (f32 q with any cache, other widths, pages not a
//   multiple of 8 tokens, other tiles) on the CUDA cores: a CTA of eight
//   warps per (item, 8 or 16 rows), 32-key tiles gathered with 16-byte
//   loads and converted to f32 in shared memory, QK a lane a key, P.V two
//   columns a thread.
// The tensor-core routes are fed by a producer that walks the item's pages:
// one TMA map for the ckv cache and one for the kpe cache (through its row
// stride), 3-D (columns, slot, page) with the page id from the page table in
// the coordinate; a 64-key tile arrives as 128-byte-swizzled blocks of 64
// columns (8 of ckv, 1 of kpe) in a stage of an mbarrier ring, and the
// stage's ckv blocks are K's first 512 columns and V, so V costs no second
// load. 8-bit caches arrive as byte stages (half of bf16's bytes) that
// producer warps convert exactly into the bf16 stages the consumers read
// (e4m3 through the hardware's conversion, int8 through the mantissa).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

enum PlanRow {
  kReq = 0, kQoTile = 1, kQoStart = 3, kKvStart = 5, kKvEnd = 6,
  kKvPageStart = 7, kQPosBase = 9,
};

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kI8 = 3 };

// What fi_mla_route answers.
enum Route { kRouteCudaCores = 0, kRouteDecode = 1, kRoutePrefill = 2 };

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
  int kv_i8, box_rows, stages, byte_stages;  // tensor-core routes
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

struct Item {
  int qo_tile, qo_start, kv_start, span, page0, q_pos_base;
};

__device__ __forceinline__ Item load_item(const Params& p, int w) {
  const int T = p.T;
  Item it;
  it.qo_tile = p.plan[kQoTile * T + w];
  it.qo_start = p.plan[kQoStart * T + w];
  it.kv_start = p.plan[kKvStart * T + w];
  it.span = p.plan[kReq * T + w] < 0
                ? 0 : max(0, p.plan[kKvEnd * T + w] - it.kv_start);
  it.page0 = p.plan[kKvPageStart * T + w];
  it.q_pos_base = p.plan[kQPosBase * T + w];
  return it;
}

// Absolute position of the token of row r of the item's tile.
__device__ __forceinline__ int q_tok(const Params& p, const Item& it, int r) {
  return it.q_pos_base + (it.qo_tile * p.tile_q + r) / p.group;
}

// Keys [0, end) of the item that rows up to `last` see.
__device__ __forceinline__ int key_end(const Params& p, const Item& it,
                                       int last) {
  int hi = it.span;
  if (p.causal) hi = min(hi, q_tok(p, it, last) - it.kv_start + 1);
  return max(hi, 0);
}

__device__ __forceinline__ bool keep(const Params& p, const Item& it, int tok,
                                     int lk) {
  return lk < it.span && !(p.causal && it.kv_start + lk > tok);
}

// The merge identity (o = 0, lse = -inf) for rows [r0, r1) of item w.
template <typename QT>
__device__ void write_identity(const Params& p, int w, int r0, int r1,
                               int tid, int nthreads) {
  r1 = min(r1, p.tile_q);
  if (r1 <= r0) return;
  QT* o = static_cast<QT*>(p.o) + (size_t(w) * p.tile_q + r0) * p.d_ckv;
  for (int i = tid; i < (r1 - r0) * p.d_ckv; i += nthreads)
    o[i] = from_f32<QT>(0.f);
  for (int i = tid; i < r1 - r0; i += nthreads)
    p.lse[size_t(w) * p.tile_q + r0 + i] = -CUDART_INF_F;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------ tensor cores

constexpr int kDCkv = 512, kDKpe = 64;  // DeepSeek's MLA widths
constexpr int kD = kDCkv + kDKpe;       // 576: the QK depth
constexpr int kKB = kD / 64;            // 64-column blocks of a key row
constexpr int kVB = kDCkv / 64;         // of them, V's (ckv's)
constexpr int kWgRows = 64;             // rows a warpgroup of the row kernel
constexpr int kTK = 64;                 // keys a tile
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448 - 256;  // bytes a CTA may use (H100)
constexpr float kLn2 = 0.6931471805599453f;
// the maps' page extent: any page id a pool can hold (the C entry is not
// told the pool's size, and the kernels read only pages of the table)
constexpr uint64_t kMapPages = uint64_t(1) << 26;

constexpr int kStage = kKB * kTK * 128;  // bytes a bf16 stage
constexpr int kByteStage = kTK * kD;      // bytes a byte stage

// A ring of key-tile stages (bf16, kKB swizzled blocks of [tk][128 B]),
// for 8-bit caches beside a ring of byte stages (ckv [tk][512], then kpe
// [tk][64]), and their barriers: full/empty a stage, bfull/bempty a byte
// stage.
struct Ring {
  unsigned char* stage;
  unsigned char* bytes;
  int n, n8;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* bfull;
  uint64_t* bempty;
};

__device__ __forceinline__ Ring make_ring(unsigned char* at, int n, int n8) {
  Ring r;
  r.stage = at;
  r.bytes = at + n * kStage;
  r.n = n;
  r.n8 = n8;
  r.full = reinterpret_cast<uint64_t*>(r.bytes + n8 * kByteStage);
  r.empty = r.full + n;
  r.bfull = r.empty + n;
  r.bempty = r.bfull + n8;
  return r;
}

// Thread 0: full takes one arrival (the producer's, with the bytes it
// expects, or a converter's), empty one a consumer warp, bfull one (with
// its bytes), bempty one a converter warp.
__device__ __forceinline__ void init_ring(const Ring& r, int consumer_warps,
                                          int converter_warps) {
  for (int i = 0; i < r.n; ++i) {
    mbar_init(&r.full[i], 1);
    mbar_init(&r.empty[i], consumer_warps);
  }
  for (int i = 0; i < r.n8; ++i) {
    mbar_init(&r.bfull[i], 1);
    mbar_init(&r.bempty[i], converter_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Issues key tile t of the item into `dst`: a bf16 stage (kKB blocks of 64
// columns, one TMA box a (page part, block)) or, 8-bit, a byte stage (one
// box a page part of each cache). Lane b issues the boxes of page part b
// (box_rows keys of one page), so a tile's boxes go out together; lane 0
// first arrives on `full` with the bytes to expect.
template <bool KV8>
__device__ __forceinline__ void issue_tile(const Params& p, const Item& it,
                                           const CUtensorMap* tm_c,
                                           const CUtensorMap* tm_p,
                                           unsigned char* dst, uint64_t* full,
                                           int t, int lane) {
  const int br = p.box_rows;
  const int nbox = (min(kTK, it.span - t * kTK) + br - 1) / br;
  if (lane == 0) mbar_expect_tx(full, nbox * br * (KV8 ? kD : kKB * 128));
  __syncwarp();
  for (int b = lane; b < nbox; b += 32) {
    const int lk = t * kTK + b * br;
    const int page = p.kv_indices[it.page0 + lk / p.page_size];
    const int slot = lk % p.page_size;
    if (KV8) {
      tma_load3(dst + b * br * kDCkv, tm_c, full, 0, slot, page);
      tma_load3(dst + kTK * kDCkv + b * br * kDKpe, tm_p, full, 0, slot, page);
    } else {
#pragma unroll
      for (int cb = 0; cb < kVB; ++cb)
        tma_load3(dst + cb * kTK * 128 + b * br * 128, tm_c, full, cb * 64,
                  slot, page);
      tma_load3(dst + kVB * kTK * 128 + b * br * 128, tm_p, full, 0, slot,
                page);
    }
  }
}

// Converts a byte stage (kTK keys) into a bf16 stage; rows from `valid` on
// become 0, so neither a stale byte nor another token's reaches P.V. ct:
// this thread among the n converting threads; UNROLL: chunks it has in
// flight (as its registers allow).
template <bool I8, int UNROLL>
__device__ __forceinline__ void convert_tile(const unsigned char* src,
                                             unsigned char* dst, int valid,
                                             int ct, int n) {
  constexpr int kChunks = kD / 16;  // 16-byte chunks a key
#pragma unroll UNROLL
  for (int i = ct; i < kTK * kChunks; i += n) {
    const int j = i / kChunks, col = (i % kChunks) * 16;
    uint2 a = make_uint2(0u, 0u), b = a, c = a, e = a;
    if (j < valid) {
      const unsigned char* s =
          col < kDCkv ? src + j * kDCkv + col
                      : src + kTK * kDCkv + j * kDKpe + (col - kDCkv);
      const uint4 x = *reinterpret_cast<const uint4*>(s);
      a = bytes4_to_bf16x4<I8>(x.x);
      b = bytes4_to_bf16x4<I8>(x.y);
      c = bytes4_to_bf16x4<I8>(x.z);
      e = bytes4_to_bf16x4<I8>(x.w);
    }
    unsigned char* blk = dst + (col >> 6) * kTK * 128;
    const int ch = (col & 63) >> 3;
    *reinterpret_cast<uint4*>(blk + sw128(j, ch)) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(blk + sw128(j, ch + 1)) =
        make_uint4(c.x, c.y, e.x, e.y);
  }
}

// The producer of key tiles [0, t1), run by n threads (ct: this one)
// beside the consumers. bf16: warp 0 keeps the stage ring full through TMA.
// 8-bit: warp 0 keeps the byte ring full, n8 - 1 tiles ahead, and all n
// threads convert each byte stage into the next bf16 stage; when every
// converter has fenced its writes for the async proxy and met at named
// barrier `bar`, one thread arrives on the stage's full barrier.
template <bool KV8, int UNROLL>
__device__ __forceinline__ void produce(const Params& p, const Item& it,
                                        const CUtensorMap* tm_c,
                                        const CUtensorMap* tm_p,
                                        const Ring& r, int t1, int ct, int n,
                                        int bar) {
  const int warp = ct >> 5, lane = ct & 31;
  if (!KV8) {
    if (warp != 0) return;
    for (int t = 0; t < t1; ++t) {
      const int st = t % r.n, ph = (t / r.n) & 1;
      if (lane == 0) mbar_wait(&r.empty[st], ph ^ 1);
      __syncwarp();
      issue_tile<false>(p, it, tm_c, tm_p, r.stage + st * kStage,
                            &r.full[st], t, lane);
    }
    return;
  }
  auto issue = [&](int t) {
    const int s8 = t % r.n8, ph8 = (t / r.n8) & 1;
    if (lane == 0) mbar_wait(&r.bempty[s8], ph8 ^ 1);
    __syncwarp();
    issue_tile<true>(p, it, tm_c, tm_p,
                         r.bytes + s8 * kByteStage, &r.bfull[s8], t,
                         lane);
  };
  if (warp == 0)
    for (int t = 0; t < min(t1, r.n8 - 1); ++t) issue(t);
  for (int t = 0; t < t1; ++t) {
    if (warp == 0 && t + r.n8 - 1 < t1) issue(t + r.n8 - 1);
    const int st = t % r.n, ph = (t / r.n) & 1;
    const int s8 = t % r.n8, ph8 = (t / r.n8) & 1;
    const unsigned char* src = r.bytes + s8 * kByteStage;
    unsigned char* dst = r.stage + st * kStage;
    const int valid = min(kTK, it.span - t * kTK);
    mbar_wait(&r.bfull[s8], ph8);
    mbar_wait(&r.empty[st], ph ^ 1);
    if (p.kv_i8)
      convert_tile<true, UNROLL>(src, dst, valid, ct, n);
    else
      convert_tile<false, UNROLL>(src, dst, valid, ct, n);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.bempty[s8]);
    bar_sync(bar, n);
    if (ct == 0) mbar_arrive(&r.full[st]);
  }
}

// Zeroes rows [valid, kTK) of `blocks` V (ckv) blocks of a bf16 stage from
// `st` on, by the n threads of named barrier `bar`, then fences them for
// wgmma: rows past the span hold other tokens or stale bytes; their P is
// 0, but a NaN there would still reach o.
__device__ __noinline__ void zero_tail_rows(unsigned char* st, int valid,
                                            int ct, int n, int bar,
                                            int blocks) {
  for (int k = ct; k < (kTK - valid) * blocks * 8; k += n) {
    const int j = valid + k / (blocks * 8), cb = (k / 8) % blocks;
    *reinterpret_cast<uint4*>(st + cb * kTK * 128 + j * 128 + (k % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  bar_sync(bar, n);
}

// Q rows [q0, q0 + rows) of the item as bf16 in kKB swizzled blocks of
// [rows][128 B]: ckv's columns, then pe's.
__device__ __forceinline__ void load_q(const Params& p, int q0, int rows,
                                       unsigned char* sQ, int ct, int n) {
  const __nv_bfloat16* qc = static_cast<const __nv_bfloat16*>(p.q_ckv);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q_pe);
  for (int i = ct; i < rows * kKB * 8; i += n) {
    const int r = i / (kKB * 8), cb = (i / 8) % kKB, ch = i % 8;
    const int col = cb * 64 + ch * 8, row = q0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.q_rows)
      x = col < kDCkv ? *reinterpret_cast<const uint4*>(
                            qc + size_t(row) * kDCkv + col)
                      : *reinterpret_cast<const uint4*>(
                            qp + size_t(row) * kDKpe + col - kDCkv);
    *reinterpret_cast<uint4*>(sQ + cb * rows * 128 + sw128(r, ch)) = x;
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Shared memory of the decode kernel: Q [kKB][NR][128 B], P^T [NR][128 B],
// the row max / sum exchange [2][4 warps][NR] floats (1024 B), the stages,
// the byte stages, the barriers, and 1024 bytes of slack to align the
// swizzle atoms.
size_t dec_smem(int nr, int s, int s8) {
  return 1024 + size_t(kKB) * nr * 128 + size_t(nr) * 128 + 1024 +
         size_t(s) * kStage + size_t(s8) * kByteStage +
         8 * (2 * s + 2 * s8);
}

// Decode tiles (tile_q = NR = 8, 16 or 32 rows): swap-AB, see the note at
// the top. One consumer warpgroup (threads 0-127); the producer warpgroup
// (bf16: its first warp issues TMA), or for 8-bit caches two converting
// warpgroups (whose first warp also issues TMA). Launch bounds of three
// warpgroups for 8-bit: ptxas then sizes the kernel below both setmaxnreg
// targets.
template <int NR, bool KV8>
__global__ void __launch_bounds__(KV8 ? 384 : 256, 1)
    mla_dec_kernel(const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_p, const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kN = NR / 2;  // S^T accumulators a thread; O^T's a block
  constexpr int kR = NR / 4;  // tile rows a thread holds: 8j + 2tq + e
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sP = sQ + kKB * NR * 128;
  float* red = reinterpret_cast<float*>(sP + NR * 128);
  const Ring r = make_ring(reinterpret_cast<unsigned char*>(red) + 1024,
                               p.stages, p.byte_stages);

  const int w = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid & 127) >> 5;
  const Item it = load_item(p, w);
  const int hi = key_end(p, it, NR - 1);
  if (hi <= 0) {  // padding item, or no row sees a key
    write_identity<bf16>(p, w, 0, NR, tid, blockDim.x);
    return;
  }
  const int t1 = (hi + kTK - 1) / kTK;
  if (tid == 0) init_ring(r, 4, KV8 ? 8 : 1);
  __syncthreads();

  if (tid >= 128) {  // ---- producer warpgroup(s)
    if (KV8)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 144;\n" ::: "memory");
    produce<KV8, 2>(p, it, &tm_c, &tm_p, r, t1, tid - 128,
                        blockDim.x - 128, 4);
    return;
  }

  // ---- the consumer warpgroup
  if (KV8) asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int g = lane >> 2, tq = lane & 3;
  load_q(p, it.qo_start, NR, sQ, tid, 128);
  fence_async_smem();
  bar_sync(1, 128);

  int tok[kR];
#pragma unroll
  for (int jr = 0; jr < kR; ++jr)
    tok[jr] = q_tok(p, it, 8 * (jr >> 1) + 2 * tq + (jr & 1));
  const int tok_lo = q_tok(p, it, 0);
  const int tail = it.span % kTK ? it.span / kTK : -1;
  const float c = p.scale_log2;
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

  for (int t = 0; t < t1; ++t) {
    const int st = t % r.n, ph = (t / r.n) & 1;
    unsigned char* ks = r.stage + st * kStage;
    // S^T = K.Q^T: s[4j + e] is key 16 warp + g (+ 8 for e >= 2) of the
    // tile against tile row 8j + 2tq + (e & 1)
    float s[kN];
    mbar_wait(&r.full[st], ph);
    wg_fence();
#pragma unroll 4
    for (int kk = 0; kk < kKB * 4; ++kk)
      wgmma_ss<NR>(s,
                   sw128_desc(ks + (kk >> 2) * kTK * 128 + (kk & 3) * 32, 16,
                              1024),
                   sw128_desc(sQ + (kk >> 2) * NR * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
    wg_commit();
    wg_wait<0>();
    hold<kN>(s);

    const bool full = (t + 1) * kTK <= it.span &&
                      !(p.causal && it.kv_start + (t + 1) * kTK - 1 > tok_lo);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      s[k] *= c;
      if (!full) {
        const int key = t * kTK + warp * 16 + g + ((k >> 1) & 1) * 8;
        if (!keep(p, it, tok[2 * (k >> 2) + (k & 1)], key))
          s[k] = -CUDART_INF_F;
      }
    }
    // the row max: this thread's two keys, the warp's 16 (lanes g), the
    // four warps'
#pragma unroll
    for (int jr = 0; jr < kR; ++jr) {
      const int k = 4 * (jr >> 1) + (jr & 1);
      float x = fmaxf(s[k], s[k + 2]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
      if (g == 0) red[warp * NR + 8 * (jr >> 1) + 2 * tq + (jr & 1)] = x;
    }
    bar_sync(1, 128);
    float alpha[kR], ms[kR];
#pragma unroll
    for (int jr = 0; jr < kR; ++jr) {
      const int row = 8 * (jr >> 1) + 2 * tq + (jr & 1);
      const float x = fmaxf(fmaxf(red[row], red[NR + row]),
                            fmaxf(red[2 * NR + row], red[3 * NR + row]));
      const float m_new = fmaxf(m[jr], x);
      ms[jr] = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      alpha[jr] = (m[jr] == -CUDART_INF_F) ? 0.f : exp2_ftz(m[jr] - ms[jr]);
      m[jr] = m_new;
      l[jr] *= alpha[jr];
    }
    // P = 2^(s - m), rounded to bf16 into P^T [row][key]
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int jr = 2 * (k >> 2) + (k & 1), hk = (k >> 1) & 1;
      const float e = exp2_ftz(s[k] - ms[jr]);  // 0 for a masked key
      l[jr] += e;
      const int row = 8 * (k >> 2) + 2 * tq + (k & 1);
      *reinterpret_cast<bf16*>(sP + row * 128 +
                               (((warp * 2 + hk) ^ (row & 7)) << 4) + 2 * g) =
          __float2bfloat16(e);
    }
    // O^T = alpha O^T + V^T.P^T: o[vb][4j + e] is column vb*64 + 16 warp +
    // g (+ 8 for e >= 2) of tile row 8j + 2tq + (e & 1)
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int k = 0; k < kN; ++k) o[vb][k] *= alpha[2 * (k >> 2) + (k & 1)];
    if (!KV8 && t == tail)
      zero_tail_rows(ks, it.span - t * kTK, tid, 128, 1, kVB);
    fence_async_smem();  // P^T visible to wgmma
    bar_sync(1, 128);
    wg_fence();
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_ss_ta<NR>(o[vb],
                        sw128_desc(ks + vb * kTK * 128 + kk * 16 * 128,
                                   kTK * 128, 1024),
                        sw128_desc(sP + kk * 32, 16, 1024), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb) hold<kN>(o[vb]);
    if (lane == 0) mbar_arrive(&r.empty[st]);
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
  bar_sync(1, 128);
  bf16* out = static_cast<bf16*>(p.o) + size_t(w) * NR * kDCkv;
#pragma unroll
  for (int jr = 0; jr < kR; ++jr) {
    const int row = 8 * (jr >> 1) + 2 * tq + (jr & 1);
    const float* lr = red + 4 * NR + row;
    const float lsum = lr[0] + lr[NR] + lr[2 * NR] + lr[3 * NR];
    const float f = lsum > 0.f ? p.v_scale / lsum : 0.f;
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
        out[size_t(row) * kDCkv + vb * 64 + warp * 16 + g + 8 * hk] =
            __float2bfloat16(o[vb][4 * (jr >> 1) + 2 * hk + (jr & 1)] * f);
    if (warp == 0 && g == 0) {
      const float ms = m[jr] == -CUDART_INF_F ? 0.f : m[jr];
      p.lse[size_t(w) * NR + row] =
          lsum > 0.f ? ms * kLn2 + logf(lsum) : -CUDART_INF_F;
    }
  }
}

// Shared memory of the row kernel: Q [kKB][64 rows][128 B], P [64 rows]
// [128 B], the two warpgroups' row maxima and sums [2][64] each (1024 B),
// the stages, the byte stages, the barriers, and 1024 bytes of slack.
size_t pre_smem(int s, int s8) {
  return 1024 + size_t(kKB) * kWgRows * 128 + kWgRows * 128 + 1024 +
         size_t(s) * kStage + size_t(s8) * kByteStage +
         8 * (2 * s + 2 * s8);
}

// Row tiles (tile_q a multiple of 64): a CTA per (item, 64 rows), see the
// note at the top. Warpgroups 0 and 1 consume alike: warpgroup c computes
// S for the tile's keys [c kTK/2, (c + 1) kTK/2) (m64n(kTK/2), 36 k-steps),
// the two exchange their row maxima through shared memory, write their
// halves of P, and each runs P.V over the whole tile for O's columns
// [256 c, 256 c + 256). Warpgroup 2 produces. No branch by warpgroup
// encloses a wgmma (ptxas would serialise them). Named barriers: 1 the
// row maxima are written (and the previous tile's P is read), 2 P is
// written, 3 + c warpgroup c, 5 the converters.
template <bool KV8>
__global__ void __launch_bounds__(384, 1)
    mla_pre_kernel(const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_p, const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kHalf = kTK / 2;        // keys a warpgroup's S
  constexpr int kS = kHalf / 2;        // S accumulators a thread
  constexpr int kO = kDCkv / 2 / 2;    // 128: O accumulators (256 columns)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sP = sQ + kKB * kWgRows * 128;
  float* s_max = reinterpret_cast<float*>(sP + kWgRows * 128);  // [2][64]
  float* s_l = s_max + 2 * kWgRows;                             // [2][64]
  const Ring r = make_ring(reinterpret_cast<unsigned char*>(s_max) + 1024,
                               p.stages, p.byte_stages);

  const int w = blockIdx.x, row0 = blockIdx.y * kWgRows;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const Item it = load_item(p, w);
  const int hi = key_end(p, it, min(row0 + kWgRows, p.tile_q) - 1);
  if (hi <= 0) {
    write_identity<bf16>(p, w, row0, row0 + kWgRows, tid, 384);
    return;
  }
  const int t1 = (hi + kTK - 1) / kTK;
  if (tid == 0) init_ring(r, 8, 4);
  __syncthreads();

  if (wg == 2) {  // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce<KV8, 1>(p, it, &tm_c, &tm_p, r, t1, wtid, 128, 5);
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  load_q(p, it.qo_start + row0, kWgRows, sQ, tid, 256);
  fence_async_smem();
  bar_sync(1, 256);
  const int g = lane >> 2, tq = lane & 3;
  const int la = warp * 16 + g, lb = la + 8;  // this thread's rows
  const int tok_a = q_tok(p, it, row0 + la), tok_b = q_tok(p, it, row0 + lb);
  const int tok_lo = q_tok(p, it, row0);
  const int tail = it.span % kTK ? it.span / kTK : -1;
  const float c = p.scale_log2;
  // S's keys wg*kHalf + 8j + 2tq + (e & 1); O's columns 256 wg + 8j + 2tq +
  // (e & 1): V blocks 4 wg to 4 wg + 3
  const int kcol = wg * kHalf * 128, vcol = wg * 4 * kTK * 128;
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < t1; ++t) {
    const int st = t % r.n, ph = (t / r.n) & 1;
    unsigned char* ks = r.stage + st * kStage;
    float s[kS];
    mbar_wait(&r.full[st], ph);
    wg_fence();
#pragma unroll 4
    for (int kk = 0; kk < kKB * 4; ++kk)
      wgmma_ss<kHalf>(s,
                      sw128_desc(sQ + (kk >> 2) * kWgRows * 128 + (kk & 3) * 32,
                                 16, 1024),
                      sw128_desc(ks + (kk >> 2) * kTK * 128 + kcol +
                                     (kk & 3) * 32, 16, 1024),
                      kk > 0);
    wg_commit();
    wg_wait<0>();
    hold<kS>(s);
    // s[4j + e]: row la (e < 2) or lb, key t kTK + wg kHalf + 8j + 2tq +
    // (e & 1)
    const bool full = (t + 1) * kTK <= it.span &&
                      !(p.causal && it.kv_start + (t + 1) * kTK - 1 > tok_lo);
    const int key0 = t * kTK + wg * kHalf + 2 * tq;
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      s[k] *= c;
      if (!full && !keep(p, it, (k & 2) ? tok_b : tok_a,
                         key0 + (k >> 2) * 8 + (k & 1)))
        s[k] = -CUDART_INF_F;
      if (k & 2)
        mx_b = fmaxf(mx_b, s[k]);
      else
        mx_a = fmaxf(mx_a, s[k]);
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    if (tq == 0) {
      s_max[wg * kWgRows + la] = mx_a;
      s_max[wg * kWgRows + lb] = mx_b;
    }
    // both maxima written; the other warpgroup is done with P of tile t - 1
    bar_sync(1, 256);
    const int other = (wg ^ 1) * kWgRows;
    const float na = fmaxf(m_a, fmaxf(mx_a, s_max[other + la]));
    const float nb = fmaxf(m_b, fmaxf(mx_b, s_max[other + lb]));
    const float sa = (na == -CUDART_INF_F) ? 0.f : na;
    const float sb = (nb == -CUDART_INF_F) ? 0.f : nb;
    const float alpha_a = (m_a == -CUDART_INF_F) ? 0.f : exp2_ftz(m_a - sa);
    const float alpha_b = (m_b == -CUDART_INF_F) ? 0.f : exp2_ftz(m_b - sb);
    m_a = na;
    m_b = nb;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int k = 0; k < kS; k += 4) {  // exp2(-inf) = 0 for masked keys
      s[k] = exp2_ftz(s[k] - sa);
      s[k + 1] = exp2_ftz(s[k + 1] - sa);
      s[k + 2] = exp2_ftz(s[k + 2] - sb);
      s[k + 3] = exp2_ftz(s[k + 3] - sb);
      sum_a += s[k] + s[k + 1];
      sum_b += s[k + 2] + s[k + 3];
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's share of l
    l_b = l_b * alpha_b + sum_b;
    // P [row][key], bf16: this warpgroup's keys are 16-byte chunks
    // wg kHalf / 8 + j of the 128-byte row
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int ch = wg * (kHalf / 8) + j;
      *reinterpret_cast<uint32_t*>(sP + la * 128 + ((ch ^ (la & 7)) << 4) +
                                   4 * tq) = pack_bf16(s[4 * j], s[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(sP + lb * 128 + ((ch ^ (lb & 7)) << 4) +
                                   4 * tq) =
          pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    if (!KV8 && t == tail)
      zero_tail_rows(ks + wg * 4 * kTK * 128, it.span - t * kTK, wtid, 128,
                         3 + wg, 4);
    fence_async_smem();  // P visible to wgmma
    bar_sync(2, 256);
#pragma unroll
    for (int k = 0; k < kO; k += 4) {
      o[k] *= alpha_a;
      o[k + 1] *= alpha_a;
      o[k + 2] *= alpha_b;
      o[k + 3] *= alpha_b;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma_ss_tb<kDCkv / 2>(o, sw128_desc(sP + kk * 32, 16, 1024),
                             sw128_desc(ks + vcol + kk * 16 * 128, kTK * 128,
                                        1024),
                             1);
    wg_commit();
    wg_wait<0>();
    hold<kO>(o);
    if (lane == 0) mbar_arrive(&r.empty[st]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (tq == 0) {
    s_l[wg * kWgRows + la] = l_a;
    s_l[wg * kWgRows + lb] = l_b;
  }
  bar_sync(1, 256);  // both warpgroups' shares of l
  bf16* out = static_cast<bf16*>(p.o) +
              (size_t(w) * p.tile_q + row0) * kDCkv + wg * (kDCkv / 2) + 2 * tq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lr = half ? lb : la;
    const float lsum = s_l[lr] + s_l[kWgRows + lr];
    const float f = lsum > 0.f ? p.v_scale / lsum : 0.f;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + size_t(lr) * kDCkv + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * f,
                                o[4 * j + 2 * half + 1] * f);
    if (wg == 0 && tq == 0) {
      const float mrow = half ? m_b : m_a;
      const float ms = mrow == -CUDART_INF_F ? 0.f : mrow;
      p.lse[size_t(w) * p.tile_q + row0 + lr] =
          lsum > 0.f ? ms * kLn2 + logf(lsum) : -CUDART_INF_F;
    }
  }
}

// A 3-D map (columns, slot, page) over a paged cache of rows `row_elems`
// elements apart. bf16: boxes of 64 columns x box_rows slots, 128-byte
// swizzle; 8-bit: the row's `width` bytes as 16-bit elements (a box holds at
// most 256 elements) x box_rows slots, unswizzled.
bool cache_map(CUtensorMap* map, const void* ptr, bool kv8, int width,
               int row_elems, int ps, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = cuuint64_t(row_elems) * (kv8 ? 1 : 2);  // bytes
  const cuuint64_t dims[3] = {cuuint64_t(kv8 ? width / 2 : width),
                              cuuint64_t(ps), kMapPages};
  const cuuint64_t strides[2] = {row, row * ps};
  const cuuint32_t box[3] = {cuuint32_t(kv8 ? width / 2 : 64),
                             cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                kv8 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                kv8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

bool make_maps(Params& p, bool kv8, CUtensorMap* tm_c, CUtensorMap* tm_p) {
  p.box_rows = gcd(p.page_size, kTK);
  return cache_map(tm_c, p.ckv, kv8, kDCkv, kDCkv, p.page_size, p.box_rows) &&
         cache_map(tm_p, p.kpe, kv8, kDKpe, p.kpe_stride, p.page_size,
                   p.box_rows);
}

template <int NR, bool KV8>
cudaError_t launch_dec(Params p, cudaStream_t s) {
  // bf16: as many stages as fit; 8-bit: two stages, then as many byte
  // stages as fit
  int stages = 2, byte_stages = KV8 ? 1 : 0;
  int& grow = KV8 ? byte_stages : stages;
  while (grow < kMaxStages &&
         dec_smem(NR, stages + !KV8, byte_stages + KV8) <= kSmemLimit)
    ++grow;
  const size_t bytes = dec_smem(NR, stages, byte_stages);
  if (bytes > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  p.stages = stages;
  p.byte_stages = byte_stages;
  CUtensorMap tm_c, tm_p;
  if (!make_maps(p, KV8, &tm_c, &tm_p)) return cudaErrorInvalidValue;
  auto kernel = mla_dec_kernel<NR, KV8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<p.T, KV8 ? 384 : 256, bytes, s>>>(tm_c, tm_p, p);
  return cudaGetLastError();
}

// The row kernel's stages: bf16 two; 8-bit one, and two byte stages.
template <bool KV8>
cudaError_t launch_pre(Params p, cudaStream_t s) {
  p.stages = KV8 ? 1 : 2;
  p.byte_stages = KV8 ? 2 : 0;
  const size_t bytes = pre_smem(p.stages, p.byte_stages);
  if (bytes > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  CUtensorMap tm_c, tm_p;
  if (!make_maps(p, KV8, &tm_c, &tm_p)) return cudaErrorInvalidValue;
  auto kernel = mla_pre_kernel<KV8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.T, p.tile_q / kWgRows), 384, bytes, s>>>(tm_c, tm_p, p);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch_dec_kv(const Params& p, int kv_dtype, cudaStream_t s) {
  return kv_dtype == kBF16 ? launch_dec<NR, false>(p, s)
                           : launch_dec<NR, true>(p, s);
}

cudaError_t launch_tc(const Params& p, int route, int kv_dtype,
                      cudaStream_t s) {
  if (route == kRoutePrefill)
    return kv_dtype == kBF16 ? launch_pre<false>(p, s) : launch_pre<true>(p, s);
  switch (p.tile_q) {
    case 8: return launch_dec_kv<8>(p, kv_dtype, s);
    case 16: return launch_dec_kv<16>(p, kv_dtype, s);
    default: return launch_dec_kv<32>(p, kv_dtype, s);
  }
}

// ------------------------------------------------------------- CUDA cores

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;     // keys per tile: one per lane
constexpr int kMaxCkv = 2 * kThreads;  // P.V: columns tid and tid + 256
constexpr int kMaxKpe = 128;

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
    lse[tid] = l > 0.f ? m_safe * kLn2 + logf(l) : -CUDART_INF_F;
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

// The route for these arguments: bf16 q at DeepSeek's widths on pages of a
// multiple of 8 tokens takes the tensor cores (decode tiles 8/16/32, row
// tiles a multiple of 64); everything else the CUDA cores.
int route(int q_dtype, int kv_dtype, int tile_q, int d_ckv, int d_kpe,
          int page_size) {
  if (q_dtype == kBF16 && (kv_dtype == kBF16 || kv_dtype == kE4M3 ||
                           kv_dtype == kI8) &&
      d_ckv == kDCkv && d_kpe == kDKpe && page_size % 8 == 0) {
    if (tile_q == 8 || tile_q == 16 || tile_q == 32) return kRouteDecode;
    if (tile_q > 0 && tile_q % kWgRows == 0) return kRoutePrefill;
  }
  return kRouteCudaCores;
}

}  // namespace

// The route fi_mla_attention takes for these arguments: 0 the CUDA cores,
// 1 the swap-AB decode kernel, 2 the 64-row kernel.
extern "C" int fi_mla_route(int q_dtype, int kv_dtype, int tile_q, int d_ckv,
                            int d_kpe, int page_size) {
  return route(q_dtype, kv_dtype, tile_q, d_ckv, d_kpe, page_size);
}

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
  // 16-byte loads (and the TMA maps): aligned caches and kpe row stride
  const int item = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  if (!(kv_dtype == q_dtype || kv_dtype == kE4M3 || kv_dtype == kI8) ||
      ((reinterpret_cast<uintptr_t>(ckv) | reinterpret_cast<uintptr_t>(kpe)) &
       15) ||
      (size_t(kpe_stride) * item) % 16)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q_ckv = q_ckv; p.q_pe = q_pe; p.ckv = ckv; p.kpe = kpe; p.plan = plan;
  p.kv_indices = kv_indices; p.o = o; p.lse = lse;
  p.T = T; p.q_rows = q_rows; p.tile_q = tile_q; p.d_ckv = d_ckv;
  p.d_kpe = d_kpe; p.kpe_stride = kpe_stride; p.page_size = page_size;
  p.group = group; p.causal = causal;
  p.kv_i8 = kv_dtype == kI8; p.box_rows = 0; p.stages = 0; p.byte_stages = 0;
  p.scale_log2 = float(double(sm_scale) * 1.4426950408889634);
  p.v_scale = v_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rt = route(q_dtype, kv_dtype, tile_q, d_ckv, d_kpe, page_size);
  if (rt != kRouteCudaCores) return int(launch_tc(p, rt, kv_dtype, s));
  cudaError_t err;
  if (q_dtype == kBF16) err = launch_kv<__nv_bfloat16>(p, kv_dtype, s);
  else if (q_dtype == kF32) err = launch_kv<float>(p, kv_dtype, s);
  else err = cudaErrorInvalidValue;
  return int(err);
}
