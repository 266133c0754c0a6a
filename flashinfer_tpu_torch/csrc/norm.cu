// RMSNorm for Hopper (sm_90a), plain or with the residual add fused in.
//
// Replaces the TPU kernel `_rmsnorm_kernel` (flashinfer_tpu/ops/norm.py:80,
// launched by `rmsnorm_pallas` :87) and carries the JAX package's
// `fused_add_rmsnorm` (:51-65), which the TPU left to XLA's fusion:
//   plain:  out = x * rsqrt(mean(x^2) + eps) * (w + weight_bias)
//   fused:  r' = round_to_T(x + residual) is written out, and out is the
//           plain norm of the rounded r' (as JAX normalises its rounded
//           new_residual), so r' matches the two-op add bit for bit.
// All arithmetic in f32, one rounding to T (bf16, f16 or f32) at the end.
//
// What bounds it on the H100: latency, not bytes. A decode row is 4-8 KB
// (hidden 2048-4096 bf16), so a launch at 8 rows moves 64-270 KB, 0.02-0.08
// us at 3.35 TB/s, against a launch, one device-memory round trip and one
// CTA reduction. The design shortens that chain:
//   * one CTA a row, each thread one 16-byte load of x (and of the
//     residual) per 8 bf16 values held in registers (512 threads at hidden
//     4096 bf16), so x is read once and the scaling runs on the registers;
//   * warp shuffles, one shared-memory exchange and one barrier, then every
//     warp finishes the sum itself (no second barrier);
//   * programmatic dependent launch: the kernel may start while its
//     predecessor runs and waits (`griddepcontrol.wait`) before it reads
//     any input, since any of them, w too, may be the predecessor's output
//     (a weight made contiguous just before, say); it lets its own
//     successor start once its loads are done;
//   * 16-byte stores of out and r'.
// Measured on the H100 (PERF.md, tools/norm_ab.py, one CUDA graph): the
// norm 1.53 us at [8, 4096] bf16 and the fused form 1.77 (1.55-1.73 and
// 2.00-2.06 beyond a matmul that writes x), against 0.52 for an empty
// kernel of the same launch. Loading w before the wait was 0.04-0.10 us
// faster alone, no faster and up to 0.4 us slower behind the matmul, and
// unsafe. Without the dependent launch the norm took 1.76-1.97 and the
// empty kernel 0.99; with 256 or 128 threads a row the fused form took
// 1.85 or 2.32.
// A hidden that is not a multiple of the 16-byte vector, or a pointer or
// row stride that is not 16-byte aligned, takes the same kernel one value
// at a time (VEC = 1). Prefill rows keep the decode layout: at [4096,
// 4096] bf16 it ran at 0.0243 ms (bound 0.0200), where 128 threads a row
// and four rows a CTA took 0.0283 (PERF.md). A thread holds at most 8
// vectors or 16 single values: hidden is at most 32768 bf16/f16 or 16384
// f32 values on the vector path, 8192 on the scalar one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads a CTA (one row)

struct Args {
  const void* x;
  const void* res;  // null: plain mode
  const void* w;
  void* out;
  void* res_out;  // r' (fused mode)
  long long sx, sr, so, sro;  // row strides, in elements
  int rows, hidden;
  float eps, weight_bias;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;  // the same bits in every lane: each step adds a pair both ways
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// One CTA a row, blockDim.x threads (a multiple of 32), each holding ITERS
// vectors of VEC values.
template <typename T, int VEC, int ITERS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const Args a) {
  using P = Pack<T, VEC>;
  const int nvec = a.hidden / VEC;
  const long long row = blockIdx.x;
  P wv[ITERS], xv[ITERS];
  griddep_wait();  // any input, w too, may be the predecessor's output
  const P* xr =
      reinterpret_cast<const P*>(static_cast<const T*>(a.x) + row * a.sx);
  const P* rr =
      reinterpret_cast<const P*>(static_cast<const T*>(a.res) + row * a.sr);
  P* ro = reinterpret_cast<P*>(static_cast<T*>(a.res_out) + row * a.sro);
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * blockDim.x;
    if (i < nvec) {
      wv[it] = static_cast<const P*>(a.w)[i];
      P v = xr[i];
      if (a.res != nullptr) {
        const P r = rr[i];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          v.v[k] = from_f32<T>(to_f32(v.v[k]) + to_f32(r.v[k]));
        ro[i] = v;
      }
      xv[it] = v;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f32(v.v[k]);
        ss += f * f;
      }
    }
  }
  griddep_launch_dependents();
  __shared__ float part[kMaxThreads / 32];
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  ss = warp_sum(ss);
  if (lane == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  const float total = warp_sum(lane < warps ? part[lane] : 0.f);
  const float rinv = rsqrtf(total / a.hidden + a.eps);
  P* orow = reinterpret_cast<P*>(static_cast<T*>(a.out) + row * a.so);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * blockDim.x;
    if (i < nvec) {
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.v[k] = from_f32<T>(to_f32(xv[it].v[k]) * rinv *
                             (to_f32(wv[it].v[k]) + a.weight_bias));
      orow[i] = o;
    }
  }
}

// The launch floor: the same grid, block and launch path, and nothing but
// the dependency wait.
__global__ void rmsnorm_empty_kernel(const Args) { griddep_wait(); }

struct Layout {
  int vec, iters, threads;  // iters 0: hidden too wide
};

// The fewest loads a thread that keep a row within kMaxThreads threads.
Layout layout_of(int hidden, int vec) {
  const int nvec = hidden / vec;
  // loads a thread holds: 16 single values, or 8 16-byte vectors (16 of
  // those, with w's, would spill past the 128 registers a thread has)
  const int max_iters = vec == 1 ? 16 : 8;
  int iters = 1;
  while (iters < max_iters && iters * kMaxThreads < nvec) iters *= 2;
  const int threads = ((nvec + iters - 1) / iters + 31) / 32 * 32;
  if (threads > kMaxThreads) return {vec, 0, 0};
  return {vec, iters, threads};
}

template <typename T, int VEC>
cudaError_t launch_vec(const Layout& L, const Args& a, bool empty,
                       cudaLaunchConfig_t& cfg) {
  if (empty) return cudaLaunchKernelEx(&cfg, rmsnorm_empty_kernel, a);
  switch (L.iters) {
    case 1: return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, 1>, a);
    case 2: return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, 2>, a);
    case 4: return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, 4>, a);
    case 8: return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, 8>, a);
    case 16:
      if constexpr (VEC == 1)
        return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, 16>, a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_typed(const Args& a, bool empty, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  auto a16 = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec =
      a.hidden % kVec == 0 && a16(a.x) && a16(a.res) && a16(a.w) &&
      a16(a.out) && a16(a.res_out) && a.sx % kVec == 0 &&
      (a.res == nullptr || (a.sr % kVec == 0 && a.sro % kVec == 0)) &&
      a.so % kVec == 0;
  const Layout L = layout_of(a.hidden, vec ? kVec : 1);
  if (L.iters == 0) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.rows);
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return vec ? launch_vec<T, kVec>(L, a, empty, cfg)
             : launch_vec<T, 1>(L, a, empty, cfg);
}

}  // namespace

// RMSNorm of `rows` rows of `hidden` values (x, and residual when it is not
// null, row strides in elements; unit column stride), dtype 0 f32, 1 bf16,
// 2 f16 for every tensor. Fused mode (residual given) writes r' to res_out.
// `empty` launches the empty kernel of the same layout instead.
extern "C" int fi_rmsnorm(const void* x, const void* residual, const void* w,
                          void* out, void* res_out, int rows, int hidden,
                          long long sx, long long sr, long long so,
                          long long sro, int dtype, float eps,
                          float weight_bias, int empty, void* stream) {
  if (rows <= 0 || hidden <= 0 || (residual != nullptr && res_out == nullptr))
    return int(cudaErrorInvalidValue);
  const Args a{x, residual, w, out, res_out, sx, sr, so, sro,
               rows, hidden, eps, weight_bias};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_typed<float>(a, empty != 0, s); break;
    case 1: err = launch_typed<__nv_bfloat16>(a, empty != 0, s); break;
    case 2: err = launch_typed<__half>(a, empty != 0, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
