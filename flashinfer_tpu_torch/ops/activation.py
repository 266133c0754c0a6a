"""Gated activations (counterpart of flashinfer_tpu/ops/activation.py:30-51).

x = [..., 2*d]: the first half is the gate input, the second the up
projection; out = act(gate) * up in f32, cast back to x's dtype.
``enable_pdl`` (a launch hint) is accepted and ignored: these are plain
PyTorch ops. ``silu_and_mul_nvfp4_batched_quantize`` follows with the
NVFP4 quantization of ``ops.fp4``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from flashinfer_tpu_torch.ops.fp4 import fp4_quantize

__all__ = ["silu_and_mul", "gelu_and_mul", "gelu_tanh_and_mul",
           "silu_and_mul_nvfp4_batched_quantize"]


def silu_and_mul(x: torch.Tensor, *, enable_pdl: bool = None) -> torch.Tensor:
    d = x.shape[-1] // 2
    g32 = x[..., :d].float()
    return (g32 * torch.sigmoid(g32) * x[..., d:].float()).to(x.dtype)


def gelu_and_mul(x: torch.Tensor, *, enable_pdl: bool = None) -> torch.Tensor:
    """Exact (erf) GeLU gate."""
    d = x.shape[-1] // 2
    g = F.gelu(x[..., :d].float(), approximate="none")
    return (g * x[..., d:].float()).to(x.dtype)


def gelu_tanh_and_mul(x: torch.Tensor, *,
                      enable_pdl: bool = None) -> torch.Tensor:
    """tanh-approximated GeLU gate."""
    d = x.shape[-1] // 2
    g = F.gelu(x[..., :d].float(), approximate="tanh")
    return (g * x[..., d:].float()).to(x.dtype)


def silu_and_mul_nvfp4_batched_quantize(a: torch.Tensor, mask: torch.Tensor,
                                        a_global_sf: torch.Tensor,
                                        sf_vec_size: int = 16
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SiLU-and-mul of a [B, M, 2 * K] (gate || up), the rows where ``mask``
    ([B, M], or broadcastable) is 0 zeroed, then NVFP4-quantized with the
    global scale ``a_global_sf``. Returns (packed e2m1 [B, M, K / 2],
    scales [B, M, K / sf_vec_size])."""
    act = silu_and_mul(a)
    mask = torch.as_tensor(mask, device=act.device)
    if mask.dim() == act.dim() - 1:
        mask = mask[..., None]
    act = act.masked_fill(mask == 0, 0)
    gs = torch.as_tensor(a_global_sf, dtype=torch.float32,
                         device=act.device).reshape(())
    return fp4_quantize(act, gs, sf_vec_size=sf_vec_size)
