"""FP4 (e2m1) quantization (counterpart of ``flashinfer_tpu/ops/fp4.py``).

Formats:
  * nvfp4: e2m1 values, an e4m3 block scale every 16 elements, one global
    f32 scale;
  * mxfp4: e2m1 values, an e8m0 (power-of-two) block scale every 32.

Values are packed two a byte (uint8), the low nibble holding the even
index, and scales are row-major, as in the JAX package, so the two
packages' bytes compare directly. The reference's swizzled scale layouts
(``SfLayout.layout_128x4``, ``shuffle_matrix_*``, ``block_scale_interleave``)
feed Blackwell's block-scaled tensor cores; nothing in the port reads them,
so they stay identities here as in JAX.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

__all__ = [
    "SfLayout",
    "fp4_quantize",
    "fp4_dequantize",
    "nvfp4_quantize",
    "mxfp4_quantize",
    "mxfp4_dequantize",
    "block_scale_interleave",
    "shuffle_matrix_a",
    "shuffle_matrix_sf_a",
    "e2m1_to_float",
]

# e2m1 code points 0..7, then the same with the sign bit (8..15)
_E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
# midpoints between consecutive e2m1 magnitudes (flashinfer_tpu/ops/fp4.py:
# 59-68): a magnitude takes the code of the bounds it exceeds
_E2M1_BOUNDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
_E2M1_MAX = 6.0


class SfLayout(enum.IntEnum):
    """Scale-factor layout, kept for the API: every layout is stored
    row-major."""

    layout_128x4 = 0
    layout_8x4 = 1
    layout_linear = 2


def _quantize_e2m1(x: torch.Tensor) -> torch.Tensor:
    """uint8 codes 0..15 of the nearest e2m1 values (ties to the lower
    magnitude: a magnitude must exceed a midpoint to round up)."""
    bounds = torch.tensor(_E2M1_BOUNDS, dtype=torch.float32, device=x.device)
    code = (x.abs()[..., None] > bounds).sum(dim=-1).to(torch.uint8)
    return code | ((x < 0).to(torch.uint8) << 3)


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., k] codes -> [..., k / 2] bytes, the even index in the low
    nibble."""
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    codes = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return codes.reshape(*packed.shape[:-1], -1)


def e2m1_to_float(codes: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(_E2M1_VALUES, dtype=torch.float32,
                         device=codes.device)
    return table[codes.long()]


def fp4_quantize(x: torch.Tensor,
                 global_scale: Optional[torch.Tensor] = None,
                 sf_vec_size: int = 16, sf_use_ue8m0: bool = False,
                 is_sf_swizzled_layout: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., k] to packed e2m1 and block scales. Returns (packed uint8
    [..., k / 2], scales uint8 [..., k / sf_vec_size]: e4m3 bits times
    ``global_scale``, or e8m0 with ``sf_use_ue8m0``). The swizzle flag is
    accepted and ignored (row-major scales)."""
    *lead, k = x.shape
    if k % sf_vec_size:
        raise ValueError(f"k={k} must be a multiple of {sf_vec_size}")
    xb = x.float().reshape(*lead, k // sf_vec_size, sf_vec_size)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    if sf_use_ue8m0:
        exp = torch.ceil(torch.log2(amax.clamp_min(1e-30) / _E2M1_MAX))
        exp = exp.clamp(-127, 127)
        scale = torch.exp2(exp)
        sf = (exp[..., 0] + 127).to(torch.uint8)
    else:
        gs = (torch.ones((), dtype=torch.float32, device=x.device)
              if global_scale is None else
              torch.as_tensor(global_scale, dtype=torch.float32,
                              device=x.device).reshape(()))
        sf_e4m3 = (amax.clamp_min(1e-30) / _E2M1_MAX * gs).to(
            torch.float8_e4m3fn)
        scale = sf_e4m3.float() / gs
        scale = torch.where(scale > 0, scale, 1.0)
        sf = sf_e4m3[..., 0].view(torch.uint8)
    codes = _quantize_e2m1(xb / scale)
    return _pack_nibbles(codes.reshape(*lead, k)), sf


def fp4_dequantize(packed: torch.Tensor, scales: torch.Tensor,
                   sf_vec_size: int = 16, sf_use_ue8m0: bool = False,
                   global_scale: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    vals = e2m1_to_float(_unpack_nibbles(packed))
    *lead, k = vals.shape
    vb = vals.reshape(*lead, k // sf_vec_size, sf_vec_size)
    if sf_use_ue8m0:
        scale = torch.exp2(scales.float() - 127.0)
    else:
        scale = scales.contiguous().view(torch.float8_e4m3fn).float()
        if global_scale is not None:
            scale = scale / torch.as_tensor(global_scale, dtype=torch.float32,
                                            device=scale.device)
    return (vb * scale[..., None]).reshape(*lead, k).to(dtype)


def nvfp4_quantize(x: torch.Tensor,
                   global_scale: Optional[torch.Tensor] = None,
                   sfLayout: SfLayout = SfLayout.layout_128x4,
                   do_shuffle: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return fp4_quantize(x, global_scale, sf_vec_size=16, sf_use_ue8m0=False)


def mxfp4_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return fp4_quantize(x, None, sf_vec_size=32, sf_use_ue8m0=True)


def mxfp4_dequantize(packed: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    return fp4_dequantize(packed, scales, sf_vec_size=32, sf_use_ue8m0=True)


def block_scale_interleave(sf: torch.Tensor) -> torch.Tensor:
    """Identity: scales are row-major."""
    return sf


def shuffle_matrix_a(x: torch.Tensor, epilogue_tile_m: int = 128
                     ) -> torch.Tensor:
    """Identity: no kernel of the port reads a shuffled operand."""
    return x


def shuffle_matrix_sf_a(sf: torch.Tensor, epilogue_tile_m: int = 128
                        ) -> torch.Tensor:
    return sf
