"""Rotary position embedding (counterpart of flashinfer_tpu/ops/rope.py):
``apply_rope_pos_ids`` (:107), the ragged-batch ``apply_rope`` (:131), the
Llama-3.1-scaled ``apply_llama31_rope_pos_ids`` (:155) and
``apply_llama31_rope`` (:181), ``rope_cos_sin_cache`` (:195), vLLM's
flattened-layout ``apply_rope_with_cos_sin_cache`` (:212) and the fused
MLA rope + e4m3 quantize prologue ``mla_rope_quantize_fp8`` (:236).
Rotate-half pairs (x[i], x[i + d/2]) unless ``interleave`` (pairs (x[2i],
x[2i+1])); f32 math, results cast back to the input dtype."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch.utils import resolve_device

__all__ = ["apply_rope", "apply_rope_pos_ids", "apply_llama31_rope",
           "apply_llama31_rope_pos_ids", "apply_rope_with_cos_sin_cache",
           "rope_cos_sin_cache", "mla_rope_quantize_fp8"]


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


def _llama31_rescale(inv_freq: torch.Tensor, factor: float,
                     low_freq_factor: float, high_freq_factor: float,
                     old_context_len: int) -> torch.Tensor:
    """Llama-3.1's frequency-dependent scaling (huggingface's "llama3"
    rope_scaling): wavelengths beyond old_context_len / low_freq_factor
    divided by ``factor``, those below old_context_len / high_freq_factor
    kept, a smooth interpolation in between."""
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = ((old_context_len / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = torch.where(wavelen > low_freq_wavelen, inv_freq / factor,
                      inv_freq)
    mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(mid, interp, out)


def _rope_with(q, k, pos_ids, inv_freq, rope_scale, rotary_dim, interleave):
    angles = (pos_ids.float() / rope_scale)[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (_apply(q, cos, sin, rotary_dim, interleave),
            _apply(k, cos, sin, rotary_dim, interleave))


def _ragged_positions(indptr: torch.Tensor, offsets: torch.Tensor,
                      nnz: int) -> torch.Tensor:
    """Token i of request b (rows indptr[b]:indptr[b + 1]) sits at position
    offsets[b] + i - indptr[b]."""
    indptr = indptr.long()
    token = torch.arange(nnz, device=indptr.device)
    b = torch.searchsorted(indptr, token, right=True) - 1
    return offsets.long()[b] + token - indptr[b]


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
    return _rope_with(q, k, pos_ids, _inv_freq(rotary_dim, rope_theta,
                                               q.device),
                      rope_scale, rotary_dim, interleave)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    indptr: torch.Tensor,
    offsets: torch.Tensor,
    *,
    rotary_dim: Optional[int] = None,
    interleave: bool = False,
    rope_scale: float = 1.0,
    rope_theta: float = 1e4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE over a ragged batch: request b's tokens are rows indptr[b]:
    indptr[b + 1] of q and k, at positions from offsets[b] on."""
    return apply_rope_pos_ids(
        q, k, _ragged_positions(indptr, offsets, q.shape[0]),
        rotary_dim=rotary_dim, interleave=interleave, rope_scale=rope_scale,
        rope_theta=rope_theta)


def apply_llama31_rope_pos_ids(
    q: torch.Tensor,
    k: torch.Tensor,
    pos_ids: torch.Tensor,
    *,
    rotary_dim: Optional[int] = None,
    interleave: bool = False,
    rope_scale: float = 8.0,
    rope_theta: float = 5e5,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    old_context_len: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE with Llama-3.1's frequency scaling (``rope_scale`` is its
    factor; positions are not divided)."""
    rotary_dim = rotary_dim or q.shape[-1]
    inv_freq = _llama31_rescale(_inv_freq(rotary_dim, rope_theta, q.device),
                                rope_scale, low_freq_factor,
                                high_freq_factor, old_context_len)
    return _rope_with(q, k, pos_ids, inv_freq, 1.0, rotary_dim, interleave)


def apply_llama31_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    indptr: torch.Tensor,
    offsets: torch.Tensor,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_llama31_rope_pos_ids`` over a ragged batch, positions as in
    ``apply_rope``."""
    return apply_llama31_rope_pos_ids(
        q, k, _ragged_positions(indptr, offsets, q.shape[0]), **kwargs)


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


def apply_rope_with_cos_sin_cache(
    positions: torch.Tensor,
    query: torch.Tensor,  # [nnz, num_qo_heads * head_size]
    key: torch.Tensor,  # [nnz, num_kv_heads * head_size]
    head_size: int,
    cos_sin_cache: torch.Tensor,  # [max_pos, rotary_dim], cos || sin
    is_neox: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """vLLM's layout: query and key flattened over heads, cos and sin read
    from the cache at ``positions``; ``is_neox`` rotates halves, else
    adjacent pairs. Returns (query, key) in their input shapes."""
    nnz = query.shape[0]
    rotary_dim = cos_sin_cache.shape[-1]
    half = rotary_dim // 2
    cs = cos_sin_cache[positions.long()].float()
    cos, sin = cs[:, :half], cs[:, half:]
    q = _apply(query.reshape(nnz, -1, head_size), cos, sin, rotary_dim,
               interleave=not is_neox)
    k = _apply(key.reshape(nnz, -1, head_size), cos, sin, rotary_dim,
               interleave=not is_neox)
    return q.reshape(query.shape), k.reshape(key.shape)


def mla_rope_quantize_fp8(
    q_rope: torch.Tensor,  # [nnz, num_heads, rope_dim]
    k_rope: torch.Tensor,  # [nnz, rope_dim]
    q_nope: torch.Tensor,  # [nnz, num_heads, nope_dim]
    k_nope: torch.Tensor,  # [nnz, nope_dim]
    cos_sin_cache: torch.Tensor,  # [max_pos, rope_dim] f32, cos||sin
    pos_ids: torch.Tensor,
    is_neox: bool = True,
    quantize_dtype: torch.dtype = torch.float8_e4m3fn,
    quant_scale_q: float = 1.0,
    quant_scale_kv: float = 1.0,
    quantize_q: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rope the MLA query and key rope parts from the cos/sin cache and
    quantize the pieces to e4m3 (value * scale, rounded to nearest):
    ``torch.float8_e4m3fn`` tensors, or with ``quantize_dtype=torch.int8``
    the same bits in int8 tensors (the JAX package's containers, as its
    ``quantize_dtype=jnp.int8`` returns them). ``quantize_q=False`` keeps q
    roped but unquantized in its input dtype. Returns (q_rope, k_rope,
    q_nope, k_nope)."""
    if cos_sin_cache.dtype != torch.float32:
        raise TypeError("cos_sin_cache must be f32")
    if quantize_dtype not in (torch.float8_e4m3fn, torch.int8):
        raise ValueError(f"quantize_dtype must be torch.float8_e4m3fn or "
                         f"torch.int8 (e4m3 bits), got {quantize_dtype}")
    rotary_dim = cos_sin_cache.shape[-1]
    half = rotary_dim // 2
    cs = cos_sin_cache[pos_ids.long()]
    cos, sin = cs[:, :half], cs[:, half:]
    qr = _apply(q_rope, cos, sin, rotary_dim, interleave=not is_neox)
    kr = _apply(k_rope[:, None, :], cos, sin, rotary_dim,
                interleave=not is_neox)[:, 0]

    def quant(x, scale):
        return (x.float() * scale).to(torch.float8_e4m3fn).view(
            quantize_dtype)

    return (
        quant(qr, quant_scale_q) if quantize_q else qr,
        quant(kr, quant_scale_kv),
        quant(q_nope, quant_scale_q) if quantize_q else q_nope,
        quant(k_nope, quant_scale_kv),
    )
