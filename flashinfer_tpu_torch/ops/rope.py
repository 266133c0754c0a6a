"""Rotary position embedding (counterpart of flashinfer_tpu/ops/rope.py):
``apply_rope_pos_ids`` (:107), ``rope_cos_sin_cache`` (:195) and the fused
MLA rope + e4m3 quantize prologue ``mla_rope_quantize_fp8`` (:236).
Rotate-half pairs (x[i], x[i + d/2]) unless ``interleave`` (pairs (x[2i],
x[2i+1])); f32 math, results cast back to the input dtype."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch.utils import resolve_device

__all__ = ["apply_rope_pos_ids", "rope_cos_sin_cache",
           "mla_rope_quantize_fp8"]


def _apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           rotary_dim: int, interleave: bool = False) -> torch.Tensor:
    xr = x[..., :rotary_dim].float()
    rest = x[..., rotary_dim:]
    cos = cos[:, None, :]  # broadcast over heads
    sin = sin[:, None, :]
    if interleave:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr.shape)
    else:
        half = rotary_dim // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), rest], dim=-1)


def _inv_freq(rotary_dim: int, rope_theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return 1.0 / (rope_theta ** exponent)


def apply_rope_pos_ids(
    q: torch.Tensor,
    k: torch.Tensor,
    pos_ids: torch.Tensor,
    *,
    rotary_dim: Optional[int] = None,
    interleave: bool = False,
    rope_scale: float = 1.0,
    rope_theta: float = 1e4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [nnz, num_qo_heads, head_dim], k: [nnz, num_kv_heads, head_dim],
    pos_ids: [nnz] integer positions."""
    rotary_dim = rotary_dim or q.shape[-1]
    inv_freq = _inv_freq(rotary_dim, rope_theta, q.device)
    angles = (pos_ids.float() / rope_scale)[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (_apply(q, cos, sin, rotary_dim, interleave),
            _apply(k, cos, sin, rotary_dim, interleave))


def rope_cos_sin_cache(
    max_position: int,
    rotary_dim: int,
    *,
    rope_theta: float = 1e4,
    rope_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """[max_position, rotary_dim]: cos in the first half, sin in the second
    (the vLLM-compatible layout ``mla_rope_quantize_fp8`` reads)."""
    device = resolve_device(device)
    inv_freq = _inv_freq(rotary_dim, rope_theta, device)
    pos = torch.arange(max_position, dtype=torch.float32,
                       device=device) / rope_scale
    angles = pos[:, None] * inv_freq[None, :]
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1).to(dtype)


def mla_rope_quantize_fp8(
    q_rope: torch.Tensor,  # [nnz, num_heads, rope_dim]
    k_rope: torch.Tensor,  # [nnz, rope_dim]
    q_nope: torch.Tensor,  # [nnz, num_heads, nope_dim]
    k_nope: torch.Tensor,  # [nnz, nope_dim]
    cos_sin_cache: torch.Tensor,  # [max_pos, rope_dim] f32, cos||sin
    pos_ids: torch.Tensor,
    is_neox: bool = True,
    quant_scale_q: float = 1.0,
    quant_scale_kv: float = 1.0,
    quantize_q: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rope the MLA query and key rope parts from the cos/sin cache and
    quantize the pieces to ``torch.float8_e4m3fn`` (value * scale, rounded
    to nearest); the JAX package's int8 containers hold the same bits
    (``.view(torch.int8)``). ``quantize_q=False`` keeps q roped but
    unquantized in its input dtype. Returns (q_rope, k_rope, q_nope,
    k_nope)."""
    if cos_sin_cache.dtype != torch.float32:
        raise TypeError("cos_sin_cache must be f32")
    rotary_dim = cos_sin_cache.shape[-1]
    half = rotary_dim // 2
    cs = cos_sin_cache[pos_ids.long()]
    cos, sin = cs[:, :half], cs[:, half:]
    qr = _apply(q_rope, cos, sin, rotary_dim, interleave=not is_neox)
    kr = _apply(k_rope[:, None, :], cos, sin, rotary_dim,
                interleave=not is_neox)[:, 0]

    def quant(x, scale):
        return (x.float() * scale).to(torch.float8_e4m3fn)

    return (
        quant(qr, quant_scale_q) if quantize_q else qr,
        quant(kr, quant_scale_kv),
        quant(q_nope, quant_scale_q) if quantize_q else q_nope,
        quant(k_nope, quant_scale_kv),
    )
