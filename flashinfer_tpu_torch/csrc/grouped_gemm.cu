// Grouped (per-expert) GEMM over a tile-aligned padded row layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_gg_kernel` (flashinfer_tpu/ops/gemm_grouped.py:
// 157, launched by grouped_gemm_padded :256). out[p] = (lhs[p] @ W_e) *
// scale[e], accumulated in f32, for every row p of an m-tile owned by expert
// e = expert_of_tile[m]; a tile with e = -1 writes zeros and reads no
// weights. Weights are [E, N, K] (rhs_nk: the models' own layout, read in
// place) or [E, K, N]. Rows are bf16 with bf16 or 8-bit weights (converted
// to bf16 in registers on their way into the tensor cores), or f32 with f32
// or 8-bit weights (CUDA cores, f32 FMA). The output is bf16 or f32, chosen
// by the caller.
//
// 8-bit weights, by dtype code:
// - kE4M3: e4m3 converted exactly (denormals kept), the MoE weights;
// - kE4M3Ftz: e4m3 decoded as the JAX package's integer bit decode
//   (flashinfer_tpu/ops/fp8.py:45): exponent-0 codes to +-0, the NaN code
//   to +-480. The dense 8-bit matmul (`w8_matmul`, the engine's `_wmm`)
//   takes this one, so the card's tokens can be held to the CPU's;
// - kI8: linear int8, exact in bf16 since |q| <= 128.
// Scales are one f32 an expert ([E]) or, with col_scales, one an output
// column of each expert ([E, N]: the per-output-channel scales of 8-bit
// weights), applied to the f32 accumulator. The dense matmul is one group:
// no expert_of_tile (every tile expert 0), and lhs and out hold only the
// `rows` real rows of the tiles' m_pad (the token map fills zeros past
// them, the stores skip them), so no padded copy of either exists.
//
// What bounds it on the H100, by regime (times: PERF.md, chip_smoke.py):
// - Decode (tm 16, at most 8 rows an expert): the weight bytes. 8 tokens x
//   top-6 of 64 experts touch ~34 experts a layer, and each touched
//   expert's [N, K] block comes from device memory once: 392 MB for the
//   V2-Lite gate/up GEMM in bf16 (0.12 ms at 3.35 TB/s), half that in e4m3,
//   for a few MFLOP. What counts is the bytes in flight on every SM.
// - V2-Lite prefill (~190 rows an expert, tm 128): the bytes again, if each
//   expert's block is read once and its other m-tile takes it from L2;
//   the padded layout adds a third to the products and two thirds to the
//   output rows.
// - A Mixtral-8x7B layer (~1000 rows an expert, tm 128): the operations
//   (1.9 TFLOP for the gate/up GEMM, 1.95 ms at 989 TFLOP/s).
// Design, one kernel for all three:
// - Swap-AB: the weights are wgmma's A operand, 64 output columns a block,
//   and the m-tile's tm token rows its N (m64 n{tm} k16), so a 16-row
//   decode tile runs no 64-row MMA on 16 rows and a CTA never spans two
//   experts. Two consumer warpgroups a CTA, each owning one block at tm 16
//   and 32 (128-column tiles, two CTAs an SM: bytes in flight) and two at
//   tm 64 and 128 (256-column tiles, one CTA an SM, a producer warpgroup
//   whose registers setmaxnreg moves to the consumers' 2 x 64 x tm
//   accumulators: half the L2 -> SM bytes an operation of 128 columns).
// - TMA and a ring: one thread of the producer keeps 64-deep K stages in
//   flight behind full/empty mbarriers, as many as fit (4-8): the weights
//   through a 3-D map over [E, N, K] or [E, K, N] with the expert in the
//   coordinate, the rows through a 2-D map over [rows, K]. The maps are
//   __grid_constant__ parameters, so a CUDA graph records them by value.
//   Past N or K the maps fill zeros and the store is masked.
// - bf16 weights: wgmma with both operands in shared memory (128-byte
//   swizzle; [E, K, N] is the MN-major A form), a stage released as the
//   next stage's products are issued. e4m3 weights arrive as bytes (half
//   the ring's bytes); each consumer reads its fragments from shared memory,
//   converts them in registers (e4m3x2 -> f16x2 -> f32 -> bf16x2; the
//   bit decode straight to bf16x2; int8 through the mantissa of 2^23) and
//   feeds them as wgmma's register A operand, one block's conversion
//   overlapping the other block's products. No bf16 copy of the weights
//   exists anywhere. int8 weights take the e4m3 path's layout and ring.
// - Order: the CTAs walk bands of 1024 rows of m-tiles, the m-tiles of a
//   band fastest, so the m-tiles of one expert and n-slab run together
//   (the slab comes from L2 after its first read) and the band's rows stay
//   in L2 across its n-slabs (1024 measured best: 512 slows decode, 2048
//   and 4096 prefill).
// - Epilogue: the accumulators hold out^T (weights x tokens); they are
//   scaled (an expert's scalar, or each accumulator row's column scale),
//   staged transposed in the ring's shared memory, and written as
//   coalesced 16-byte rows of bf16 or f32, rows past `rows` skipped. A -1
//   tile writes its zeros and leaves.
// - Dense 8-bit matmul at Llama-3-8B's shapes: decode (8 rows, tm 16) and
//   the 32-row verify step are bound by the weight bytes, half of bf16's;
//   4096-row prefill (tm 128) by the operations at the bf16 rate. One
//   group has one m-tile at decode, so a 4096-wide output alone makes 16
//   CTAs: the caller splits K (splits > 1) until the CTAs fill the card;
//   each split writes its f32 partial tile to a workspace, and the last to
//   arrive on the tile's counter sums them in split order (the same bits
//   whichever arrives last), scales, stores, and zeroes the counter.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kI8 = 3, kE4M3Ftz = 4 };

// The e4m3 bits that take the bit decode (kE4M3Ftz): one byte, as
// __nv_fp8_e4m3 and int8_t.
struct e4m3_ftz {
  uint8_t bits;
};

constexpr int kThreads = 128;              // CUDA-core kernel
constexpr int kConsumers = 2;              // consumer warpgroups a CTA
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // one CTA an SM
constexpr int kTileK = 64;                 // K a ring stage
constexpr int kSmemSm = 232448;            // bytes a CTA may use (H100)
constexpr int kMaxStages = 8;
constexpr int kBandRows = 1024;            // rows of a band of m-tiles

struct Params {
  const void* lhs;      // [rows, K]
  const void* rhs;      // [E, K, N] or [E, N, K]
  const int* eot;       // [m_pad / tm], or null: every tile expert 0
  const float* scales;  // [E], or [E, N] with col_scales
  void* out;            // [rows, N]
  int m_pad, rows, K, N, tm, E, rhs_nk, out_f32, col_scales;
  int m_tiles, band;    // m-tiles, and m-tiles a band
  // split K: `splits` CTAs a tile, each over k_tiles_split 64-deep stages;
  // each writes its f32 partial tile to ws, and the last to arrive on the
  // tile's counter (sem, zero between launches) sums them in split order
  int splits, k_tiles_split;
  float* ws;
  int* sem;
};

// The scale of expert e's output column n.
__device__ __forceinline__ float scale_of(const Params& p, int e, int n) {
  return p.col_scales ? p.scales[size_t(e) * p.N + n] : p.scales[e];
}

// Geometry of a (tm, weight type, layout). A consumer warpgroup owns kBlk
// blocks of 64 output columns: one at tm 16 and 32 (decode: two CTAs an
// SM, each CTA 128 columns), two at tm 64 and 128 (prefill: one CTA an SM
// of 256 columns, half the L2 -> SM bytes an operation) and for 8-bit
// [E, K, N] weights at every tm (each k row of a stage then reads 256
// contiguous bytes, not 128: 0.0943 -> 0.0653 ms for Llama-3-8B's decode
// gate/up in int8, tools/w8_ab.py; at [E, N, K] V2-Lite's MoE decode went
// 0.0497 -> 0.0540, so those keep 128; 512 columns, or two CTAs an SM of
// 256, were slower). A ring stage holds the weight tile
// [kTileN, kTileK] and the token tile [tm, kTileK] (bf16, 128 B a row); the
// ring takes what the CTAs an SM leave.
template <int TM, typename WT, bool NK>
struct Geo {
  static constexpr int kBlk = TM >= 64 || (sizeof(WT) == 1 && !NK) ? 2 : 1;
  static constexpr int kCtas = 3 - kBlk;  // CTAs an SM
  // the producer: a warp, or at one CTA an SM a warpgroup, so that
  // setmaxnreg can move its registers to the consumers' 2 x 64 x tm
  // accumulators
  static constexpr int kThreads = kConsumerThreads + (kCtas == 1 ? 128 : 32);
  static constexpr int kTileN = 64 * kConsumers * kBlk;
  static constexpr int kLd = kTileN + 4;  // staged f32 row: conflict-free
  static constexpr int kWBytes = kTileN * kTileK * int(sizeof(WT));
  static constexpr int kStage = kWBytes + TM * kTileK * 2;
  static constexpr int kFit =
      ((kSmemSm + 1024) / kCtas - 2048 - 2 * kMaxStages * 8) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kStages >= 2, "two stages at least");
  static_assert(TM * kLd * 4 <= kStages * kStage, "staging fits the ring");
};

// Two 8-bit weights (low byte first) as a bf16x2 register.
template <typename WT>
__device__ __forceinline__ uint32_t w8x2_to_bf16x2(uint16_t x);

// e4m3, exactly
template <>
__device__ __forceinline__ uint32_t w8x2_to_bf16x2<__nv_fp8_e4m3>(uint16_t x) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3));
  const float2 f = __half22float2(h);
  return pack_bf16(f.x, f.y);
}

// linear int8: byte b + 128 in the low mantissa of 2^23, minus 2^23 + 128
// (exact in f32)
template <>
__device__ __forceinline__ uint32_t w8x2_to_bf16x2<int8_t>(uint16_t x) {
  const uint32_t u = uint32_t(x) ^ 0x8080u;
  const float kBias = 8388736.f;  // 2^23 + 128
  return pack_bf16(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias);
}

// e4m3 by the bit decode, straight to bf16: (e << 3 | m) << 4 plus the
// exponent rebias 120 << 7; exponent-0 codes to signed zero; 0x7F (NaN)
// lands on 480
template <>
__device__ __forceinline__ uint32_t w8x2_to_bf16x2<e4m3_ftz>(uint16_t x) {
  const uint32_t v = (uint32_t(x) & 0xFFu) | ((uint32_t(x) & 0xFF00u) << 8);
  uint32_t h = ((v & 0x007F007Fu) << 4) + 0x3C003C00u;
  if (!(v & 0x00000078u)) h &= 0xFFFF0000u;
  if (!(v & 0x00780000u)) h &= 0x0000FFFFu;
  return h | ((v & 0x00800080u) << 8);
}

// One weight as f32, for the CUDA-core kernel.
template <typename WT>
__device__ __forceinline__ float w_to_f32(const WT* w, size_t i) {
  return static_cast<float>(w[i]);
}
template <>
__device__ __forceinline__ float w_to_f32<e4m3_ftz>(const e4m3_ftz* w,
                                                    size_t i) {
  return __uint_as_float(w8x2_to_bf16x2<e4m3_ftz>(w[i].bits) << 16);
}

// The register A fragments (m16n8k16 layout, rows r0 and r0 + 8 of block
// blk's 64 output columns) of the four k16 steps of an 8-bit weight stage,
// converted to bf16. [E, N, K]: 64 rows of 64 bytes a block, TMA's 64-byte
// swizzle (chunk ^= (row >> 1) & 3). [E, K, N]: boxes of 64 k rows x 128
// columns, 128-byte swizzle (chunk ^= row & 7), read a byte at a time.
template <typename WT, bool NK>
__device__ __forceinline__ void w8_frags(const unsigned char* w, int blk,
                                         int r0, int t, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (i & 1) * 8;       // weight row (output column)
      const int k = kk * 16 + 2 * t + (i >> 1) * 8;
      uint16_t x;
      if (NK) {
        x = *reinterpret_cast<const uint16_t*>(
            w + blk * 64 * 64 + r * 64 +
            ((((k >> 4) ^ ((r >> 1) & 3)) << 4) | (k & 15)));
      } else {
        const int n = blk * 64 + r;
        const unsigned char* box = w + (n >> 7) * (64 * 128);
        const int c = n & 127;
        x = uint16_t(box[k * 128 + ((((c >> 4) ^ (k & 7)) << 4) | (c & 15))]) |
            uint16_t(box[(k + 1) * 128 +
                         ((((c >> 4) ^ ((k + 1) & 7)) << 4) | (c & 15))]
                     << 8);
      }
      a[kk][i] = w8x2_to_bf16x2<WT>(x);
    }
  }
}

// Split K: write this split's partial tile (staged in sc, [TM][kLd]) to its
// slot of ws; the last split of the tile to arrive sums the slots in split
// order (the same order every launch: the result does not depend on which
// split arrives last), scales each column and stores the rows below
// p.rows. Called by the consumer threads only.
template <int TM, int kTileN, int kLd>
__device__ __forceinline__ void split_fixup(const Params& p, const float* sc,
                                            int tile, int split, int e,
                                            int row0, int n0, int tid) {
  __shared__ int s_last;
  constexpr int kVec = kTileN / 4;  // float4 a row
  float* ws = p.ws + size_t(tile) * p.splits * TM * kTileN;
  for (int i = tid; i < TM * kVec; i += kConsumerThreads) {
    const int row = i / kVec, c = (i % kVec) * 4;
    __stcg(reinterpret_cast<float4*>(ws + (size_t(split) * TM + row) * kTileN
                                     + c),
           *reinterpret_cast<const float4*>(sc + row * kLd + c));
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (tid == 0) {
    s_last = atomicAdd(p.sem + tile, 1) == p.splits - 1;
    if (s_last) p.sem[tile] = 0;  // every split has arrived: reset
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < TM * kVec; i += kConsumerThreads) {
    const int row = i / kVec, c = (i % kVec) * 4, col = n0 + c;
    if (col >= p.N || row0 + row >= p.rows) continue;
    float4 a = __ldcg(reinterpret_cast<const float4*>(ws + row * kTileN + c));
    for (int s2 = 1; s2 < p.splits; ++s2) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          ws + (size_t(s2) * TM + row) * kTileN + c));
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    a.x *= scale_of(p, e, col);
    a.y *= scale_of(p, e, col + 1);
    a.z *= scale_of(p, e, col + 2);
    a.w *= scale_of(p, e, col + 3);
    const size_t off = size_t(row0 + row) * p.N + col;
    if (p.out_f32)
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + off) = a;
    else
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + off) =
          make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

template <int TM, typename WT, bool NK>
__global__ void __launch_bounds__(Geo<TM, WT, NK>::kThreads,
                                  Geo<TM, WT, NK>::kCtas)
    grouped_gemm_tc_kernel(const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_x,
                           const Params p) {
  using R = Geo<TM, WT, NK>;
  constexpr int S = R::kStages, kBlk = R::kBlk, kTileN = R::kTileN;
  constexpr int kLd = R::kLd, kTcThreads = R::kThreads;
  constexpr bool kF8 = sizeof(WT) == 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * R::kStage);
  uint64_t* empty = full + S;

  // bands of p.band m-tiles, the m-tiles of a band fastest; the splits of
  // a tile adjacent
  const int n_tiles = (p.N + kTileN - 1) / kTileN;
  const int per_band = p.band * n_tiles;
  const int tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int band = tile / per_band, r = tile % per_band;
  const int rows_b = min(p.band, p.m_tiles - band * p.band);
  const int m = band * p.band + r % rows_b, n0 = (r / rows_b) * kTileN;
  const int row0 = m * TM, e = p.eot ? p.eot[m] : 0;
  const int tid = threadIdx.x;

  if (e < 0) {  // past the used tiles: zeros, no weight read
    if (split > 0) return;
    const int vec = p.out_f32 ? 4 : 8;  // elements a 16-byte store
    const int per_row = kTileN / vec;
    for (int i = tid; i < TM * per_row; i += kTcThreads) {
      const int row = row0 + i / per_row, col = n0 + (i % per_row) * vec;
      if (col >= p.N || row >= p.rows) continue;
      const size_t off = size_t(row) * p.N + col;
      uint4* dst = p.out_f32
                       ? reinterpret_cast<uint4*>(static_cast<float*>(p.out) + off)
                       : reinterpret_cast<uint4*>(
                             static_cast<__nv_bfloat16*>(p.out) + off);
      *dst = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int kt0 = split * p.k_tiles_split;
  const int k_tiles =
      min(p.k_tiles_split, (p.K + kTileK - 1) / kTileK - kt0);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: one thread keeps the ring full through TMA
    if constexpr (R::kCtas == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumerThreads) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % S, ph = (kt / S) & 1, k0 = (kt0 + kt) * kTileK;
        unsigned char* sw = base + st * R::kStage;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], R::kStage);
        if (NK) {
          tma_load3(sw, &tm_w, &full[st], k0, n0, e);
        } else {  // MN-major boxes of 128 bytes of columns x 64 k rows
          constexpr int kCols = 128 / int(sizeof(WT));
#pragma unroll
          for (int b = 0; b < kTileN / kCols; ++b)
            tma_load3(sw + b * 64 * 128, &tm_w, &full[st], n0 + b * kCols,
                      k0, e);
        }
        tma_load2(sw + R::kWBytes, &tm_x, &full[st], k0, row0);
      }
    }
    return;
  }
  if constexpr (R::kCtas == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumers: warpgroup wg owns blocks wg * kBlk + b of 64 columns
  const int wg = tid >> 7, lane = tid & 31, warp = (tid & 127) >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[kBlk][TM / 2];  // the first k16 step overwrites (scale_d 0)
  uint32_t a[kBlk][4][4];  // 8-bit: one fragment buffer a block

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % S, ph = (kt / S) & 1;
    const unsigned char* sw = base + st * R::kStage;
    const unsigned char* sx = sw + R::kWBytes;
    mbar_wait(&full[st], ph);
    if constexpr (!kF8) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(sx + kk * 32, 16, 1024);
#pragma unroll
        for (int b = 0; b < kBlk; ++b) {
          const unsigned char* wb = sw + (wg * kBlk + b) * 8192;
          if constexpr (NK)
            wgmma_ss<TM>(acc[b], sw128_desc(wb + kk * 32, 16, 1024), db,
                         kt > 0 || kk > 0);
          else
            wgmma_ss_ta<TM>(acc[b],
                            sw128_desc(wb + kk * 16 * 128, 8192, 1024), db,
                            kt > 0 || kk > 0);
        }
      }
      wg_commit();
      // the previous stage's products are done: release it
      wg_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt + S - 1) % S]);
    } else if constexpr (kBlk == 1) {
      w8_frags<WT, NK>(sw, wg, warp * 16 + g, t, a[0]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_kb<TM>(acc[0], a[0][kk], sw128_desc(sx + kk * 32, 16, 1024),
                        kt > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      hold<16>(&a[0][0][0]);
      if (lane == 0) mbar_arrive(&empty[st]);
    } else {
      // block b's conversion overlaps the other block's products in
      // flight; each wait retires the group before, whose fragments are
      // then free (the wait after the loop retires the last)
#pragma unroll
      for (int b = 0; b < kBlk; ++b) {
        w8_frags<WT, NK>(sw, wg * kBlk + b, warp * 16 + g, t, a[b]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_kb<TM>(acc[b], a[b][kk],
                          sw128_desc(sx + kk * 32, 16, 1024), kt > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
        hold<16>(&a[(b + kBlk - 1) % kBlk][0][0]);
        if (b == 0 && kt > 0 && lane == 0)
          mbar_arrive(&empty[(kt + S - 1) % S]);
      }
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int b = 0; b < kBlk; ++b) hold<TM / 2>(acc[b]);

  // Epilogue: acc[b][4j + c] is output column n0 + 64 (wg kBlk + b) + 16
  // warp + g (+ 8 for c >= 2) of token row 8j + 2t + (c & 1). Every load
  // has landed and every product is done once both warpgroups pass the
  // barrier, so the ring holds the scaled tile (a split's partial:
  // unscaled), transposed, for coalesced stores.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  float* sc = reinterpret_cast<float*>(base);
  // the scales of this thread's accumulator rows (output columns)
  float cs[kBlk][2];
#pragma unroll
  for (int b = 0; b < kBlk; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + (wg * kBlk + b) * 64 + warp * 16 + g + 8 * h;
      cs[b][h] = p.splits > 1 ? 1.f : col < p.N ? scale_of(p, e, col) : 0.f;
    }
#pragma unroll
  for (int b = 0; b < kBlk; ++b)
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[(8 * j + 2 * t + (c & 1)) * kLd + (wg * kBlk + b) * 64 +
           warp * 16 + g + 8 * (c >> 1)] = acc[b][4 * j + c] * cs[b][c >> 1];
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (p.splits > 1) {
    split_fixup<TM, kTileN, kLd>(p, sc, tile, split, e, row0, n0, tid);
    return;
  }
  if (p.out_f32) {
    float* out = static_cast<float*>(p.out);
    for (int i = tid; i < TM * kTileN / 4; i += kConsumerThreads) {
      const int row = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
      if (n0 + c < p.N && row0 + row < p.rows)
        *reinterpret_cast<float4*>(out + size_t(row0 + row) * p.N + n0 + c) =
            *reinterpret_cast<const float4*>(sc + row * kLd + c);
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    for (int i = tid; i < TM * kTileN / 8; i += kConsumerThreads) {
      const int row = i / (kTileN / 8), c = (i % (kTileN / 8)) * 8;
      if (n0 + c >= p.N || row0 + row >= p.rows) continue;
      const float4 x0 = *reinterpret_cast<const float4*>(sc + row * kLd + c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(sc + row * kLd + c + 4);
      *reinterpret_cast<uint4*>(out + size_t(row0 + row) * p.N + n0 + c) =
          make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                     pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
    }
  }
}

// f32 rows with f32 or 8-bit weights on the CUDA cores: a thread per output
// column, 16 rows at a time. The f32 models are the small reference
// configurations.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_f32_kernel(const Params p) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int row0 = m * p.tm, e = p.eot ? p.eot[m] : 0;
  const int tile_rows = min(p.tm, p.rows - row0);
  if (n >= p.N) return;
  float* out = static_cast<float*>(p.out);
  __nv_bfloat16* out_bf = static_cast<__nv_bfloat16*>(p.out);
  if (e < 0) {
    for (int r = 0; r < tile_rows; ++r) {
      const size_t off = size_t(row0 + r) * p.N + n;
      if (p.out_f32) out[off] = 0.f; else out_bf[off] = __float2bfloat16(0.f);
    }
    return;
  }
  const float* lhs = static_cast<const float*>(p.lhs) + size_t(row0) * p.K;
  const WT* w = static_cast<const WT*>(p.rhs) + size_t(e) * p.K * p.N;
  const float scale = scale_of(p, e, n);
  for (int r0 = 0; r0 < tile_rows; r0 += 16) {
    const int rows = min(16, tile_rows - r0);
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int k = 0; k < p.K; ++k) {
      const float wv = w_to_f32(w, p.rhs_nk ? size_t(n) * p.K + k
                                            : size_t(k) * p.N + n);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < rows) acc[i] = fmaf(lhs[size_t(r0 + i) * p.K + k], wv, acc[i]);
    }
    for (int i = 0; i < rows; ++i) {
      const size_t off = size_t(row0 + r0 + i) * p.N + n;
      if (p.out_f32) out[off] = acc[i] * scale;
      else out_bf[off] = __float2bfloat16(acc[i] * scale);
    }
  }
}

// The weights' 3-D map, zero fill past N and K: [E, N, K] in boxes of
// kTileK x tile_n (64-byte swizzle for e4m3's 64-byte rows), or [E, K, N]
// in boxes of 64 k rows x 128 bytes of columns (128-byte swizzle).
template <typename WT, bool NK>
bool weight_map(CUtensorMap* map, const Params& p, int tile_n) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr bool kF8 = sizeof(WT) == 1;
  const cuuint64_t es = sizeof(WT), K = p.K, N = p.N;
  const cuuint64_t dims[3] = {NK ? K : N, NK ? N : K, cuuint64_t(p.E)};
  const cuuint64_t strides[2] = {(NK ? K : N) * es, K * N * es};
  const cuuint32_t box[3] = {NK ? cuuint32_t(kTileK) : cuuint32_t(128 / es),
                             NK ? cuuint32_t(tile_n) : cuuint32_t(kTileK), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                kF8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(p.rhs), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                (NK && kF8) ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rows' 2-D map over [rows, K] bf16, boxes of tm rows x 64 columns,
// zero fill past the rows (up to the tiles' m_pad) and past K.
bool token_map(CUtensorMap* map, const Params& p) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(p.K), cuuint64_t(p.rows)};
  const cuuint64_t strides[1] = {cuuint64_t(p.K) * 2};
  const cuuint32_t box[2] = {kTileK, cuuint32_t(p.tm)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p.lhs), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TM, typename WT, bool NK>
cudaError_t launch_at(const Params& p, cudaStream_t s) {
  using R = Geo<TM, WT, NK>;
  constexpr int kTileN = R::kTileN;
  CUtensorMap tm_w, tm_x;
  if (!weight_map<WT, NK>(&tm_w, p, kTileN) || !token_map(&tm_x, p))
    return cudaErrorInvalidValue;
  auto kernel = grouped_gemm_tc_kernel<TM, WT, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.N + kTileN - 1) / kTileN;
  kernel<<<p.m_tiles * n_tiles * p.splits, R::kThreads, R::kSmem, s>>>(
      tm_w, tm_x, p);
  return cudaGetLastError();
}

template <int TM, typename WT>
cudaError_t launch_layout(const Params& p, cudaStream_t s) {
  return p.rhs_nk ? launch_at<TM, WT, true>(p, s)
                  : launch_at<TM, WT, false>(p, s);
}

template <typename WT>
cudaError_t launch_tc(const Params& p, cudaStream_t s) {
  switch (p.tm) {
    case 16: return launch_layout<16, WT>(p, s);
    case 32: return launch_layout<32, WT>(p, s);
    case 64: return launch_layout<64, WT>(p, s);
    case 128: return launch_layout<128, WT>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename WT>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  dim3 grid(p.m_tiles, (p.N + kThreads - 1) / kThreads);
  grouped_gemm_f32_kernel<WT><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// lhs [rows, K] and out [rows, N] hold the first `rows` of the tiles' m_pad
// rows (rows == m_pad for the grouped layouts).
extern "C" int fi_grouped_gemm(const void* lhs, const void* rhs,
                               const int* expert_of_tile, const float* scales,
                               void* out, int m_pad, int rows, int K, int N,
                               int tm, int num_experts, int rhs_nk,
                               int lhs_dtype, int rhs_dtype, int out_dtype,
                               int col_scales, int splits, int k_tiles_split,
                               float* ws, int* sem, void* stream) {
  if (tm <= 0 || m_pad % tm != 0 || rows <= 0 || rows > m_pad || K <= 0 ||
      N <= 0 || !(out_dtype == kF32 || out_dtype == kBF16) || splits < 1 ||
      (splits > 1 && (lhs_dtype != kBF16 || ws == nullptr || sem == nullptr ||
                      k_tiles_split < 1 ||
                      (splits - 1) * k_tiles_split >= (K + kTileK - 1) / kTileK)))
    return int(cudaErrorInvalidValue);
  Params p;
  p.lhs = lhs; p.rhs = rhs; p.eot = expert_of_tile; p.scales = scales;
  p.out = out; p.m_pad = m_pad; p.rows = rows; p.K = K; p.N = N; p.tm = tm;
  p.E = num_experts; p.rhs_nk = rhs_nk; p.out_f32 = out_dtype == kF32;
  p.col_scales = col_scales;
  p.splits = splits;
  p.k_tiles_split = splits > 1 ? k_tiles_split : (K + kTileK - 1) / kTileK;
  p.ws = ws; p.sem = sem;
  p.m_tiles = m_pad / tm;
  p.band = max(1, min(p.m_tiles, kBandRows / tm));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lhs_dtype == kF32) {
    switch (rhs_dtype) {
      case kF32: return int(launch_f32<float>(p, s));
      case kE4M3: return int(launch_f32<__nv_fp8_e4m3>(p, s));
      case kI8: return int(launch_f32<int8_t>(p, s));
      case kE4M3Ftz: return int(launch_f32<e4m3_ftz>(p, s));
      default: return int(cudaErrorInvalidValue);
    }
  }
  // TMA reads 16-byte-aligned rows; the stores are 16 bytes wide
  const uintptr_t addr = reinterpret_cast<uintptr_t>(lhs) |
                         reinterpret_cast<uintptr_t>(rhs) |
                         reinterpret_cast<uintptr_t>(out);
  if (lhs_dtype != kBF16 || K % 32 != 0 || N % 16 != 0 || (addr & 15))
    return int(cudaErrorInvalidValue);
  switch (rhs_dtype) {
    case kBF16: return int(launch_tc<__nv_bfloat16>(p, s));
    case kE4M3: return int(launch_tc<__nv_fp8_e4m3>(p, s));
    case kI8: return int(launch_tc<int8_t>(p, s));
    case kE4M3Ftz: return int(launch_tc<e4m3_ftz>(p, s));
    default: return int(cudaErrorInvalidValue);
  }
}
