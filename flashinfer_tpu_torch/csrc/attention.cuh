// Pieces shared by the paged and MLA attention kernels: the base-2 online
// softmax's exponent and power-of-two rescale, quad reductions over a
// wgmma accumulator row, and the exact 8-bit -> bf16 conversion of cache
// bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 2^k for an integer k <= 0, exactly. The paged kernel's online softmax
// subtracts the ceiling of the running base-2 max, an integer, so each
// rescale is a power of two: P rounded to bf16 against the running max,
// then rescaled, equals P rounded against the final one (as
// paged_attention_plain rounds it). The MLA kernels keep the exact max.
__device__ __forceinline__ float pow2(float k) {
  return k < -126.f ? 0.f : __int_as_float((int(k) + 127) << 23);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Four 8-bit values (low byte first) as two bf16x2 registers, exactly.
// e4m3: the hardware's e4m3x2 -> f16x2, then f32 and bf16x2. int8: byte
// b + 128 placed in the low mantissa of 2^23, minus 2^23 + 128 (exact in
// f32; no integer-to-float conversion).
template <bool I8>
__device__ __forceinline__ uint2 bytes4_to_bf16x4(uint32_t x) {
  if (I8) {
    const uint32_t u = x ^ 0x80808080u;
    const float kBias = 8388736.f;  // 2^23 + 128
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias;
    return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
  }
  const float2 a = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xffff), __NV_E4M3)));
  const float2 b = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x >> 16), __NV_E4M3)));
  return make_uint2(pack_bf16(a.x, a.y), pack_bf16(b.x, b.y));
}

}  // namespace
