"""FP8 (e4m3) decode and quantization (counterpart of
``flashinfer_tpu/ops/fp8.py``).

``e4m3_bits_to_bf16`` is the JAX package's integer decode, bit for bit:
denormal codes flush to signed zero and the NaN code decodes to +-480.
The card's own conversion (``.to()``, ``cvt``) keeps denormals, so the port
uses this decode wherever it must equal the JAX package: 8-bit weights
(``ops/gemm_grouped.w8_matmul``; its kernel decodes the same way) and the
fp8 GEMMs of ``ops/gemm.py``. MXFP8 is e4m3 values with one power-of-two
(e8m0) scale a 32-wide block.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "mxfp8_quantize",
    "mxfp8_dequantize",
    "fp8_quantize_rowwise",
    "e4m3_bits_to_bf16",
    "fp8_to_bf16",
]

_MX_BLOCK = 32
_E4M3_MAX = 448.0


def e4m3_bits_to_bf16(b_int8: torch.Tensor) -> torch.Tensor:
    """e4m3fn bits held in an int8 (or uint8) tensor as bfloat16: exponent
    rebias by shifts and adds, exponent-0 codes (zero and the denormals) to
    signed zero, the NaN code (0x7F) to 480 (flashinfer_tpu/ops/fp8.py:
    45-71)."""
    b = b_int8.to(torch.int32) & 0xFF
    s = (b & 0x80) << 24
    em = (b & 0x7F) << 20  # (e << 23 | m << 20) in one shift
    out = torch.where(em < (1 << 23), s, s | (em + 0x3C000000))
    return out.view(torch.float32).to(torch.bfloat16)


def fp8_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as bf16: ``float8_e4m3fn`` and int8 (the JAX package's
    container of e4m3 bits, not integer values) through
    ``e4m3_bits_to_bf16``; every other dtype by a plain cast."""
    if x.dtype == torch.float8_e4m3fn:
        return e4m3_bits_to_bf16(x.view(torch.int8))
    if x.dtype == torch.int8:
        return e4m3_bits_to_bf16(x)
    return x.to(torch.bfloat16)


def mxfp8_quantize(x: torch.Tensor, is_sf_swizzled_layout: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., k] to e4m3 with one e8m0 scale a 32-wide block, the smallest
    power of two that brings the block's amax to 448 or below. Scales stay
    row-major (the swizzle flag is accepted and ignored, as in JAX).
    Returns (values float8_e4m3fn [..., k], scales uint8 [..., k / 32])."""
    *lead, k = x.shape
    if k % _MX_BLOCK:
        raise ValueError(f"k={k} must be a multiple of {_MX_BLOCK}")
    xb = x.float().reshape(*lead, k // _MX_BLOCK, _MX_BLOCK)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    exp = torch.ceil(torch.log2(amax.clamp_min(1e-30) / _E4M3_MAX))
    exp = exp.clamp(-127, 127)
    q = (xb / torch.exp2(exp)).to(torch.float8_e4m3fn)
    sf = (exp[..., 0] + 127).to(torch.uint8)
    return q.reshape(*lead, k), sf


def mxfp8_dequantize(values: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of ``mxfp8_quantize``, in f32."""
    *lead, k = values.shape
    vb = values.float().reshape(*lead, k // _MX_BLOCK, _MX_BLOCK)
    scale = torch.exp2(scales.float() - 127.0)[..., None]
    return (vb * scale).reshape(*lead, k)


def fp8_quantize_rowwise(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row e4m3: (values float8_e4m3fn, f32 scales [rows]) with scale =
    amax / 448."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / _E4M3_MAX
    return (xf / scale).to(torch.float8_e4m3fn), scale[..., 0]
