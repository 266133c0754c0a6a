// Grouped (per-expert) GEMM over a tile-aligned padded row layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_gg_kernel` (flashinfer_tpu/ops/gemm_grouped.py:
// 157, launched by grouped_gemm_padded :256). out[p] = lhs[p] @ (rhs[e] *
// scale[e]) for every row p of an m-tile owned by expert e =
// expert_of_tile[m]; a tile with e = -1 writes zeros and reads no weights.
// Weights are [E, K, N], or [E, N, K] (rhs_nk: the models' own layout, read
// in place). Rows are bf16 with bf16 or e4m3 weights (e4m3 converts to bf16
// in hardware on its way into shared memory; the products accumulate in
// f32 on the tensor cores), or f32 with f32 weights (CUDA cores, f32 FMA).
// The output is bf16 or f32, chosen by the caller.
//
// What bounds it on the H100: at decode the weight read. 8 tokens x top-6
// of 64 experts touch ~34 experts per layer, and each touched expert's
// [K, N] block must come from device memory once: ~392 MB for the V2-Lite
// gate/up GEMM and ~196 MB for the down GEMM, ~0.18 ms a layer at 3.35
// TB/s, while the products are a few MFLOP. At prefill it is bound by the
// operations. Design: one CTA of four warps per (m-tile, 128-column
// n-tile). Every m-tile holds one expert's rows, so the CTA is a dense GEMM
// that streams its expert's K x 128 block once in 32-deep K steps with
// 16-byte loads (consecutive threads on consecutive addresses), prefetching
// the next step into registers while the tensor cores (mma.sync m16n8k16
// bf16) work on the current one. The m-tile is the caller's: 16 rows at
// decode, where an expert holds at most 8 of a batch's rows, so padding
// wastes little MMA work and each weight block is read once per m-tile.
// TMA, wgmma and a shared-memory ring are later work; so is an fp8 MMA (the
// e4m3 weights go through bf16, as the TPU kernel's bit decode does).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2 };

constexpr int kThreads = 128;  // four warps
constexpr int kTileN = 128;
constexpr int kTileK = 32;
constexpr int kStride = kTileK + 8;  // bf16 per shared row: 80 B, conflict-free

struct Params {
  const void* lhs;      // [m_pad, K]
  const void* rhs;      // [E, K, N] or [E, N, K]
  const int* eot;       // [m_pad / tm]
  const float* scales;  // [E]
  void* out;            // [m_pad, N]
  int m_pad, K, N, tm, E, rhs_nk, out_f32;
};

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          float x0, float x1) {
  const size_t off = size_t(row) * p.N + col;
  if (p.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
        make_float2(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                       off) = __floats2bfloat162_rn(x0, x1);
  }
}

__device__ void zero_tile(const Params& p, int row0, int col0, int rows,
                          int cols) {
  for (int i = threadIdx.x; i < rows * cols / 2; i += blockDim.x) {
    const int r = i / (cols / 2), c = (i % (cols / 2)) * 2;
    if (col0 + c < p.N) store_out(p, row0 + r, col0 + c, 0.f, 0.f);
  }
}

// Warp tiling of a TM x 128 CTA tile over four warps.
template <int TM>
struct Tiling {
  static constexpr int kWarpsM = TM >= 64 ? 2 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kM16 = TM / (16 * kWarpsM);  // m16 fragments a warp
  static constexpr int kN8 = kTileN / (8 * kWarpsN);  // n8 fragments a warp
  static constexpr int kAVecs = (TM * kTileK / 8 + kThreads - 1) / kThreads;
};

// One K step of weights in registers: 16-byte vectors of the expert's block.
template <typename WT>
struct BVecs {
  static constexpr int kElems = 16 / sizeof(WT);
  static constexpr int kCount = kTileN * kTileK / kElems / kThreads;
  uint4 v[kCount];
};

template <typename WT>
__device__ __forceinline__ void load_b(const Params& p, const WT* w, int n0,
                                       int k0, BVecs<WT>& b) {
  constexpr int E = BVecs<WT>::kElems;
#pragma unroll
  for (int i = 0; i < BVecs<WT>::kCount; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    size_t off;
    if (p.rhs_nk) {  // [N, K]: a vector is E consecutive k of one column
      const int n = idx / (kTileK / E), kc = (idx % (kTileK / E)) * E;
      off = size_t(n0 + n) * p.K + k0 + kc;
    } else {  // [K, N]: a vector is E consecutive columns of one k
      const int k = idx / (kTileN / E), nc = (idx % (kTileN / E)) * E;
      off = size_t(k0 + k) * p.N + n0 + nc;
    }
    b.v[i] = __ldg(reinterpret_cast<const uint4*>(w + off));
  }
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_fp8_e4m3 x) {
  return __float2bfloat16(static_cast<float>(x));  // exact
}

// Weights land in shared memory n-major (sB[n][k]), the layout of the
// MMA's B fragments.
template <typename WT>
__device__ __forceinline__ void store_b(const Params& p, const BVecs<WT>& b,
                                        __nv_bfloat16* sB) {
  constexpr int E = BVecs<WT>::kElems;
#pragma unroll
  for (int i = 0; i < BVecs<WT>::kCount; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const WT* x = reinterpret_cast<const WT*>(&b.v[i]);
    if (p.rhs_nk) {
      const int n = idx / (kTileK / E), kc = (idx % (kTileK / E)) * E;
      if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
        *reinterpret_cast<uint4*>(sB + n * kStride + kc) = b.v[i];
      } else {
        __align__(16) __nv_bfloat16 y[E];
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = to_bf16(x[e]);
        *reinterpret_cast<uint4*>(sB + n * kStride + kc) =
            *reinterpret_cast<const uint4*>(y);
        *reinterpret_cast<uint4*>(sB + n * kStride + kc + 8) =
            *reinterpret_cast<const uint4*>(y + 8);
      }
    } else {
      const int k = idx / (kTileN / E), nc = (idx % (kTileN / E)) * E;
#pragma unroll
      for (int e = 0; e < E; ++e) sB[(nc + e) * kStride + k] = to_bf16(x[e]);
    }
  }
}

template <int TM, typename WT>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_tc_kernel(const Params p) {
  using Tl = Tiling<TM>;
  __shared__ __align__(16) __nv_bfloat16 sA[TM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sB[kTileN * kStride];

  const int m = blockIdx.x, n0 = blockIdx.y * kTileN;
  const int row0 = m * TM;
  const int e = p.eot[m];
  if (e < 0) {  // past the used tiles: zeros, no weight read
    zero_tile(p, row0, n0, TM, kTileN);
    return;
  }
  const __nv_bfloat16* lhs =
      static_cast<const __nv_bfloat16*>(p.lhs) + size_t(row0) * p.K;
  const WT* w = static_cast<const WT*>(p.rhs) + size_t(e) * p.K * p.N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / Tl::kWarpsN) * Tl::kM16 * 16;
  const int wn0 = (warp % Tl::kWarpsN) * Tl::kN8 * 8;

  float acc[Tl::kM16][Tl::kN8][4];
#pragma unroll
  for (int i = 0; i < Tl::kM16; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  uint4 a_reg[Tl::kAVecs];
  BVecs<WT> b_reg;
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tl::kAVecs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < TM * kTileK / 8) {
        const int r = idx / (kTileK / 8), c = (idx % (kTileK / 8)) * 8;
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(
            lhs + size_t(r) * p.K + k0 + c));
      }
    }
  };
  load_a(0);
  load_b<WT>(p, w, n0, 0, b_reg);

  for (int k0 = 0; k0 < p.K; k0 += kTileK) {
    __syncthreads();  // the previous step's fragments are read
#pragma unroll
    for (int i = 0; i < Tl::kAVecs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < TM * kTileK / 8) {
        const int r = idx / (kTileK / 8), c = (idx % (kTileK / 8)) * 8;
        *reinterpret_cast<uint4*>(sA + r * kStride + c) = a_reg[i];
      }
    }
    store_b<WT>(p, b_reg, sB);
    __syncthreads();
    if (k0 + kTileK < p.K) {  // next step's loads fly during the MMAs
      load_a(k0 + kTileK);
      load_b<WT>(p, w, n0, k0 + kTileK, b_reg);
    }
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t af[Tl::kM16][4], bf[Tl::kN8][2];
#pragma unroll
      for (int i = 0; i < Tl::kM16; ++i) {
        const __nv_bfloat16* a0 = sA + (wm0 + i * 16 + g) * kStride + kk + 2 * t;
        const __nv_bfloat16* a1 = a0 + 8 * kStride;
        af[i][0] = *reinterpret_cast<const uint32_t*>(a0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(a1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(a1 + 8);
      }
#pragma unroll
      for (int j = 0; j < Tl::kN8; ++j) {
        const __nv_bfloat16* b0 = sB + (wn0 + j * 8 + g) * kStride + kk + 2 * t;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(b0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(b0 + 8);
      }
#pragma unroll
      for (int i = 0; i < Tl::kM16; ++i)
#pragma unroll
        for (int j = 0; j < Tl::kN8; ++j) mma_16816(acc[i][j], af[i], bf[j]);
    }
  }

  const float scale = p.scales[e];
#pragma unroll
  for (int i = 0; i < Tl::kM16; ++i) {
#pragma unroll
    for (int j = 0; j < Tl::kN8; ++j) {
      const int r = row0 + wm0 + i * 16 + g;
      const int c = n0 + wn0 + j * 8 + 2 * t;
      store_out(p, r, c, acc[i][j][0] * scale, acc[i][j][1] * scale);
      store_out(p, r + 8, c, acc[i][j][2] * scale, acc[i][j][3] * scale);
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

template <typename WT>
cudaError_t launch_tc(const Params& p, cudaStream_t s) {
  dim3 grid(p.m_pad / p.tm, p.N / kTileN);
  switch (p.tm) {
    case 16: grouped_gemm_tc_kernel<16, WT><<<grid, kThreads, 0, s>>>(p); break;
    case 32: grouped_gemm_tc_kernel<32, WT><<<grid, kThreads, 0, s>>>(p); break;
    case 64: grouped_gemm_tc_kernel<64, WT><<<grid, kThreads, 0, s>>>(p); break;
    case 128: grouped_gemm_tc_kernel<128, WT><<<grid, kThreads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rhs_dtype == kF32) {
    if (lhs_dtype != kF32) return int(cudaErrorInvalidValue);
    dim3 grid(m_pad / tm, (N + kThreads - 1) / kThreads);
    grouped_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(p);
    return int(cudaGetLastError());
  }
  if (lhs_dtype != kBF16 || K % kTileK != 0 || N % kTileN != 0)
    return int(cudaErrorInvalidValue);
  if (rhs_dtype == kBF16) return int(launch_tc<__nv_bfloat16>(p, s));
  if (rhs_dtype == kE4M3) return int(launch_tc<__nv_fp8_e4m3>(p, s));
  return int(cudaErrorInvalidValue);
}
