"""Bit packing for compressed custom attention masks (counterpart of
``flashinfer_tpu/ops/quantization.py``): 8 entries a byte, "big" bit order
(the first entry in the high bit) by default, as numpy's ``packbits``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["packbits", "segment_packbits", "unpackbits"]

_WEIGHTS = {"big": (128, 64, 32, 16, 8, 4, 2, 1),
            "little": (1, 2, 4, 8, 16, 32, 64, 128)}


def _weights(bitorder: str, device) -> torch.Tensor:
    if bitorder not in _WEIGHTS:
        raise ValueError(f"bitorder must be 'big'/'little', got {bitorder!r}")
    return torch.tensor(_WEIGHTS[bitorder], dtype=torch.int32, device=device)


def packbits(x: torch.Tensor, bitorder: str = "big") -> torch.Tensor:
    """Pack a boolean/integer vector into uint8, 8 entries a byte; the last
    byte is zero-padded."""
    w = _weights(bitorder, x.device)
    bits = (x.reshape(-1).to(torch.int32) & 1)
    bits = torch.nn.functional.pad(bits, (0, (-bits.numel()) % 8))
    return (bits.reshape(-1, 8) * w).sum(-1).to(torch.uint8)


def unpackbits(x: torch.Tensor, n: int, bitorder: str = "big") -> torch.Tensor:
    """Inverse of ``packbits``: the first ``n`` bits as bool."""
    w = _weights(bitorder, x.device)
    bits = (x.reshape(-1, 1).to(torch.int32) & w) != 0
    return bits.reshape(-1)[:n]


def segment_packbits(x: torch.Tensor, indptr, bitorder: str = "big"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack each CSR segment ``x[indptr[b]:indptr[b+1]]`` on its own, so
    every segment starts on a byte. Returns (packed, new_indptr). The
    segment bounds are host data (mask preparation happens at plan time),
    so this runs in numpy and returns tensors on ``x``'s device."""
    x_np = x.detach().cpu().numpy().astype(np.uint8) & 1
    indptr_np = np.asarray(indptr.cpu() if torch.is_tensor(indptr) else indptr,
                           np.int64)
    seg = indptr_np[1:] - indptr_np[:-1]
    new_indptr = np.concatenate([[0], np.cumsum(-(-seg // 8))])
    out = np.zeros(int(new_indptr[-1]), np.uint8)
    for b in range(len(seg)):
        out[new_indptr[b]:new_indptr[b + 1]] = np.packbits(
            x_np[indptr_np[b]:indptr_np[b + 1]], bitorder=bitorder)
    return (torch.from_numpy(out).to(x.device),
            torch.from_numpy(new_indptr.astype(np.int32)).to(x.device))
