"""Small shared helpers: KV layout enum, integer rounding, device checks.

Counterpart of ``flashinfer_tpu/utils/__init__.py``: its enums and its
device-neutral helpers. Its TPU mechanics (``on_tpu``,
``default_interpret``, ``sublane_multiple``, ``LAST_DIM_LANES``) have no
counterpart: the port runs on the card or, for CPU tensors, the plain
versions.
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
    "round_down",
    "next_power_of_2",
    "canonicalize_dtype",
    "is_float8",
    "get_compute_dtype",
    "check_kv_layout",
    "expand_gqa",
    "pad_to",
    "get_sliding_window_mask",
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


def round_down(x: int, m: int) -> int:
    return (x // m) * m


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


def canonicalize_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("bfloat16") or a numpy
    dtype (ml_dtypes' bfloat16 and float8 names included)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    t = getattr(torch, name, None)
    if not isinstance(t, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return t


_F8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def is_float8(dtype) -> bool:
    return canonicalize_dtype(dtype) in _F8_DTYPES


def get_compute_dtype(dtype) -> torch.dtype:
    """The dtype attention math runs in: bf16 for bf16 and fp8 inputs
    (8-bit tiles are converted to bf16 on their way into the tensor cores),
    f32 otherwise."""
    dtype = canonicalize_dtype(dtype)
    if is_float8(dtype) or dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def expand_gqa(kv: torch.Tensor, num_qo_heads: int,
               head_axis: int = -2) -> torch.Tensor:
    """KV heads repeated to the query heads (each kv head's copies
    adjacent)."""
    num_kv_heads = kv.shape[head_axis]
    if num_kv_heads == num_qo_heads:
        return kv
    if num_qo_heads % num_kv_heads:
        raise ValueError(f"{num_qo_heads} q heads are not a multiple of "
                         f"{num_kv_heads} kv heads")
    return kv.repeat_interleave(num_qo_heads // num_kv_heads, dim=head_axis)


def pad_to(x: torch.Tensor, size: int, axis: int, value=0) -> torch.Tensor:
    """``x`` padded with ``value`` at the end of ``axis`` to ``size``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"axis {axis} has {cur} > {size} entries")
    shape = list(x.shape)
    shape[axis] = size - cur
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def get_sliding_window_mask(qo_len: int, kv_len: int, window_left: int,
                            device=None) -> torch.Tensor:
    """Boolean [qo_len, kv_len] left-window mask (True = keep): query i, at
    position kv_len - qo_len + i, sees key j iff j > pos - window_left - 1;
    every key for ``window_left`` < 0."""
    if window_left < 0:
        return torch.ones(qo_len, kv_len, dtype=torch.bool, device=device)
    q_pos = torch.arange(qo_len, device=device)[:, None] + (kv_len - qo_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos > q_pos - window_left - 1


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
