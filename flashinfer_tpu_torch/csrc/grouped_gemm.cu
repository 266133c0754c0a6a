// Grouped (per-expert) GEMM over a tile-aligned padded row layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_gg_kernel` (flashinfer_tpu/ops/gemm_grouped.py:
// 157, launched by grouped_gemm_padded :256). out[p] = (lhs[p] @ W_e) *
// scale[e], accumulated in f32, for every row p of an m-tile owned by expert
// e = expert_of_tile[m]; a tile with e = -1 writes zeros and reads no
// weights. Weights are [E, N, K] (rhs_nk: the models' own layout, read in
// place) or [E, K, N]. Rows are bf16 with bf16 or e4m3 weights (e4m3 is
// converted exactly to bf16 on its way into the tensor cores, as the TPU
// kernel's bit decode does), or f32 with f32 weights (CUDA cores, f32 FMA).
// The output is bf16 or f32, chosen by the caller.
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
//   coordinate, the rows through a 2-D map over [m_pad, K]. The maps are
//   __grid_constant__ parameters, so a CUDA graph records them by value.
//   Past N or K the maps fill zeros and the store is masked.
// - bf16 weights: wgmma with both operands in shared memory (128-byte
//   swizzle; [E, K, N] is the MN-major A form), a stage released as the
//   next stage's products are issued. e4m3 weights arrive as bytes (half
//   the ring's bytes); each consumer reads its fragments from shared memory,
//   converts them in registers (e4m3x2 -> f16x2 -> f32 -> bf16x2, exact)
//   and feeds them as wgmma's register A operand, one block's conversion
//   overlapping the other block's products. No bf16 copy of the weights
//   exists anywhere.
// - Order: the CTAs walk bands of 1024 rows of m-tiles, the m-tiles of a
//   band fastest, so the m-tiles of one expert and n-slab run together
//   (the slab comes from L2 after its first read) and the band's rows stay
//   in L2 across its n-slabs (1024 measured best: 512 slows decode, 2048
//   and 4096 prefill).
// - Epilogue: the accumulators hold out^T (weights x tokens); they are
//   scaled, staged transposed in the ring's shared memory, and written as
//   coalesced 16-byte rows of bf16 or f32. A -1 tile writes its zeros and
//   leaves.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2 };

constexpr int kThreads = 128;              // CUDA-core kernel
constexpr int kConsumers = 2;              // consumer warpgroups a CTA
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // one CTA an SM
constexpr int kTileK = 64;                 // K a ring stage
constexpr int kSmemSm = 232448;            // bytes a CTA may use (H100)
constexpr int kMaxStages = 8;
constexpr int kBandRows = 1024;            // rows of a band of m-tiles

struct Params {
  const void* lhs;      // [m_pad, K]
  const void* rhs;      // [E, K, N] or [E, N, K]
  const int* eot;       // [m_pad / tm]
  const float* scales;  // [E]
  void* out;            // [m_pad, N]
  int m_pad, K, N, tm, E, rhs_nk, out_f32;
  int m_tiles, band;    // m-tiles, and m-tiles a band
};

// Geometry of a (tm, weight type). A consumer warpgroup owns kBlk blocks
// of 64 output columns: one at tm 16 and 32 (decode: two CTAs an SM, each
// CTA 128 columns), two at tm 64 and 128 (prefill: one CTA an SM of 256
// columns, half the L2 -> SM bytes an operation). A ring stage holds the
// weight tile [kTileN, kTileK] and the token tile [tm, kTileK] (bf16, 128
// B a row); the ring takes what the CTAs an SM leave.
template <int TM, typename WT>
struct Geo {
  static constexpr int kBlk = TM >= 64 ? 2 : 1;
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

// Two e4m3 values (low byte first) as a bf16x2 register, exactly.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint16_t x) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3));
  const float2 f = __half22float2(h);
  return pack_bf16(f.x, f.y);
}

// The register A fragments (m16n8k16 layout, rows r0 and r0 + 8 of block
// blk's 64 output columns) of the four k16 steps of an e4m3 weight stage,
// converted to bf16. [E, N, K]: 64 rows of 64 bytes a block, TMA's 64-byte
// swizzle (chunk ^= (row >> 1) & 3). [E, K, N]: boxes of 64 k rows x 128
// columns, 128-byte swizzle (chunk ^= row & 7), read a byte at a time.
template <bool NK>
__device__ __forceinline__ void e4m3_frags(const unsigned char* w, int blk,
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
      a[kk][i] = e4m3x2_to_bf16x2(x);
    }
  }
}

template <int TM, typename WT, bool NK>
__global__ void __launch_bounds__(Geo<TM, WT>::kThreads, Geo<TM, WT>::kCtas)
    grouped_gemm_tc_kernel(const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_x,
                           const Params p) {
  using R = Geo<TM, WT>;
  constexpr int S = R::kStages, kBlk = R::kBlk, kTileN = R::kTileN;
  constexpr int kLd = R::kLd, kTcThreads = R::kThreads;
  constexpr bool kF8 = sizeof(WT) == 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * R::kStage);
  uint64_t* empty = full + S;

  // bands of p.band m-tiles, the m-tiles of a band fastest
  const int n_tiles = (p.N + kTileN - 1) / kTileN;
  const int per_band = p.band * n_tiles;
  const int band = blockIdx.x / per_band, r = blockIdx.x % per_band;
  const int rows_b = min(p.band, p.m_tiles - band * p.band);
  const int m = band * p.band + r % rows_b, n0 = (r / rows_b) * kTileN;
  const int row0 = m * TM, e = p.eot[m];
  const int tid = threadIdx.x;

  if (e < 0) {  // past the used tiles: zeros, no weight read
    const int vec = p.out_f32 ? 4 : 8;  // elements a 16-byte store
    const int per_row = kTileN / vec;
    for (int i = tid; i < TM * per_row; i += kTcThreads) {
      const int row = row0 + i / per_row, col = n0 + (i % per_row) * vec;
      if (col >= p.N) continue;
      const size_t off = size_t(row) * p.N + col;
      uint4* dst = p.out_f32
                       ? reinterpret_cast<uint4*>(static_cast<float*>(p.out) + off)
                       : reinterpret_cast<uint4*>(
                             static_cast<__nv_bfloat16*>(p.out) + off);
      *dst = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int k_tiles = (p.K + kTileK - 1) / kTileK;

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
        const int st = kt % S, ph = (kt / S) & 1, k0 = kt * kTileK;
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
  uint32_t a[kBlk][4][4];  // e4m3: one fragment buffer a block

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
      e4m3_frags<NK>(sw, wg, warp * 16 + g, t, a[0]);
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
        e4m3_frags<NK>(sw, wg * kBlk + b, warp * 16 + g, t, a[b]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_kb<TM>(acc[b], a[b][kk],
                          sw128_desc(sx + kk * 32, 16, 1024), kt > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
        hold<16>(&a[b ^ 1][0][0]);
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
  // barrier, so the ring holds the scaled tile, transposed, for coalesced
  // stores.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  float* sc = reinterpret_cast<float*>(base);
  const float scale = p.scales[e];
#pragma unroll
  for (int b = 0; b < kBlk; ++b)
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[(8 * j + 2 * t + (c & 1)) * kLd + (wg * kBlk + b) * 64 +
           warp * 16 + g + 8 * (c >> 1)] = acc[b][4 * j + c] * scale;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (p.out_f32) {
    float* out = static_cast<float*>(p.out);
    for (int i = tid; i < TM * kTileN / 4; i += kConsumerThreads) {
      const int row = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
      if (n0 + c < p.N)
        *reinterpret_cast<float4*>(out + size_t(row0 + row) * p.N + n0 + c) =
            *reinterpret_cast<const float4*>(sc + row * kLd + c);
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    for (int i = tid; i < TM * kTileN / 8; i += kConsumerThreads) {
      const int row = i / (kTileN / 8), c = (i % (kTileN / 8)) * 8;
      if (n0 + c >= p.N) continue;
      const float4 x0 = *reinterpret_cast<const float4*>(sc + row * kLd + c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(sc + row * kLd + c + 4);
      *reinterpret_cast<uint4*>(out + size_t(row0 + row) * p.N + n0 + c) =
          make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                     pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
    }
  }
}

// f32 rows and weights on the CUDA cores: a thread per output column, 16
// rows at a time. The f32 models are the small reference configurations.
__global__ void __launch_bounds__(kThreads)
grouped_gemm_f32_kernel(const Params p) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int row0 = m * p.tm, e = p.eot[m];
  if (n >= p.N) return;
  float* out = static_cast<float*>(p.out);
  __nv_bfloat16* out_bf = static_cast<__nv_bfloat16*>(p.out);
  if (e < 0) {
    for (int r = 0; r < p.tm; ++r) {
      const size_t off = size_t(row0 + r) * p.N + n;
      if (p.out_f32) out[off] = 0.f; else out_bf[off] = __float2bfloat16(0.f);
    }
    return;
  }
  const float* lhs = static_cast<const float*>(p.lhs) + size_t(row0) * p.K;
  const float* w = static_cast<const float*>(p.rhs) + size_t(e) * p.K * p.N;
  const float scale = p.scales[e];
  for (int r0 = 0; r0 < p.tm; r0 += 16) {
    const int rows = min(16, p.tm - r0);
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int k = 0; k < p.K; ++k) {
      const float wv = p.rhs_nk ? w[size_t(n) * p.K + k] : w[size_t(k) * p.N + n];
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

// The rows' 2-D map over [m_pad, K] bf16, boxes of tm rows x 64 columns.
bool token_map(CUtensorMap* map, const Params& p) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(p.K), cuuint64_t(p.m_pad)};
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
  using R = Geo<TM, WT>;
  constexpr int kTileN = R::kTileN;
  CUtensorMap tm_w, tm_x;
  if (!weight_map<WT, NK>(&tm_w, p, kTileN) || !token_map(&tm_x, p))
    return cudaErrorInvalidValue;
  auto kernel = grouped_gemm_tc_kernel<TM, WT, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.N + kTileN - 1) / kTileN;
  kernel<<<p.m_tiles * n_tiles, R::kThreads, R::kSmem, s>>>(tm_w, tm_x, p);
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

}  // namespace

extern "C" int fi_grouped_gemm(const void* lhs, const void* rhs,
                               const int* expert_of_tile, const float* scales,
                               void* out, int m_pad, int K, int N, int tm,
                               int num_experts, int rhs_nk, int lhs_dtype,
                               int rhs_dtype, int out_dtype, void* stream) {
  if (tm <= 0 || m_pad % tm != 0 || K <= 0 || N <= 0 ||
      !(out_dtype == kF32 || out_dtype == kBF16))
    return int(cudaErrorInvalidValue);
  Params p;
  p.lhs = lhs; p.rhs = rhs; p.eot = expert_of_tile; p.scales = scales;
  p.out = out; p.m_pad = m_pad; p.K = K; p.N = N; p.tm = tm;
  p.E = num_experts; p.rhs_nk = rhs_nk; p.out_f32 = out_dtype == kF32;
  p.m_tiles = m_pad / tm;
  p.band = max(1, min(p.m_tiles, kBandRows / tm));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rhs_dtype == kF32) {
    if (lhs_dtype != kF32) return int(cudaErrorInvalidValue);
    dim3 grid(m_pad / tm, (N + kThreads - 1) / kThreads);
    grouped_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(p);
    return int(cudaGetLastError());
  }
  // TMA reads 16-byte-aligned rows; the stores are 16 bytes wide
  const uintptr_t addr = reinterpret_cast<uintptr_t>(lhs) |
                         reinterpret_cast<uintptr_t>(rhs) |
                         reinterpret_cast<uintptr_t>(out);
  if (lhs_dtype != kBF16 || K % 32 != 0 || N % 16 != 0 || (addr & 15))
    return int(cudaErrorInvalidValue);
  if (rhs_dtype == kBF16) return int(launch_tc<__nv_bfloat16>(p, s));
  if (rhs_dtype == kE4M3) return int(launch_tc<__nv_fp8_e4m3>(p, s));
  return int(cudaErrorInvalidValue);
}
