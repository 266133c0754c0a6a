"""Gated activations (counterpart of flashinfer_tpu/ops/activation.py:30-43).

x = [..., 2*d]: the first half is the gate input, the second the up
projection; out = act(gate) * up in f32, cast back to x's dtype.
``enable_pdl`` (a launch hint) is accepted and ignored: these are plain
PyTorch ops."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["silu_and_mul", "gelu_and_mul"]


def silu_and_mul(x: torch.Tensor, *, enable_pdl: bool = None) -> torch.Tensor:
    d = x.shape[-1] // 2
    g32 = x[..., :d].float()
    return (g32 * torch.sigmoid(g32) * x[..., d:].float()).to(x.dtype)


def gelu_and_mul(x: torch.Tensor, *, enable_pdl: bool = None) -> torch.Tensor:
    """Exact (erf) GeLU gate."""
    d = x.shape[-1] // 2
    g = F.gelu(x[..., :d].float(), approximate="none")
    return (g * x[..., d:].float()).to(x.dtype)
