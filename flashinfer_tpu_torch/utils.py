"""Small shared helpers: KV layout enum, integer rounding, device checks.

Counterpart of ``flashinfer_tpu/utils/__init__.py`` for the PyTorch port
(only what the ported paths need, and the three enums the package
exports).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "MaskMode",
    "PosEncodingMode",
    "TensorLayout",
    "apply_logits_soft_cap",
    "cdiv",
    "round_up",
    "next_power_of_2",
    "check_kv_layout",
    "resolve_device",
    "tensor_from_numpy",
]


class MaskMode(enum.IntEnum):
    """Attention mask modes (flashinfer_tpu/utils/__init__.py:43)."""

    NON_CAUSAL = 0
    CAUSAL = 1
    CUSTOM = 2
    MULTIITEMSCORING = 3


class TensorLayout(enum.IntEnum):
    """KV-cache layout. NHD = [..., seq, heads, dim]; HND = [..., heads, seq, dim]."""

    NHD = 0
    HND = 1


class PosEncodingMode(enum.IntEnum):
    """Positional encoding the single-request attention entry points apply
    (flashinfer_tpu/utils/__init__.py:52)."""

    NONE = 0
    ROPE_LLAMA = 1
    ALIBI = 2


def apply_logits_soft_cap(logits: torch.Tensor, soft_cap: float) -> torch.Tensor:
    """``cap * tanh(logits / cap)``; identity when ``soft_cap`` is 0."""
    if soft_cap <= 0.0:
        return logits
    return soft_cap * torch.tanh(logits / soft_cap)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


def check_kv_layout(layout: str | TensorLayout) -> TensorLayout:
    if isinstance(layout, TensorLayout):
        return layout
    layout = layout.upper()
    if layout not in ("NHD", "HND"):
        raise KeyError(f"Invalid kv_layout {layout!r}; must be 'NHD' or 'HND'")
    return TensorLayout[layout]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere in
    the package; asking for it on a machine without a card is an error, never
    a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flashinfer_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev


def tensor_from_numpy(arr, device: torch.device) -> torch.Tensor:
    """A numpy array (as the JAX package's arrays convert) as a tensor on
    ``device``; ml_dtypes bfloat16 and float8_e4m3fn arrays keep their
    bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)
