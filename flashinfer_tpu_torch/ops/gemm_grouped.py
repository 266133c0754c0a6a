"""Grouped (per-expert) GEMM over a tile-aligned padded row layout.

Counterpart of flashinfer_tpu/ops/gemm_grouped.py. The CUDA kernel
``flashinfer_tpu_torch/csrc/grouped_gemm.cu`` replaces the TPU kernel
``_gg_kernel`` (gemm_grouped.py:157, launched by ``grouped_gemm_padded``
:256); its source note says what bounds it on the H100 and how the design
answers.

Layout: rows sorted by expert are scattered so that every expert's segment
starts on a ``tm``-row tile boundary (``make_group_layout``). Each m-tile
then belongs to one expert (``expert_of_tile``, -1 for the unused tiles
past the last segment), and the GEMM is dense per tile. ``m_pad`` is a
static bound, so the layout is built on the device with no host sync.

Weights: ``rhs [E, K, N]``, or with ``rhs_nk`` the ``[E, N, K]`` layout
that the models store (w13 [E, 2*inter, hidden], w2 [E, hidden, inter]),
read in place with no transposed copy. bf16, f32, or ``float8_e4m3fn``
with a per-expert scale (the JAX package's int8 containers of e4m3 bits
are the same bytes: ``.view(torch.float8_e4m3fn)``). Its K-permutation for
the TPU bit decode (``fp8_k_permutation``) has no counterpart here: the
card converts e4m3 to bf16 in registers on its way into the tensor cores.
The bf16/e4m3 kernel reads through TMA, so its tensors start on 16-byte
boundaries (PyTorch's allocations do).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.utils import round_up

__all__ = [
    "GroupLayout",
    "make_group_layout",
    "grouped_gemm_padded",
    "grouped_gemm_padded_plain",
    "grouped_gemm",
]

# dtype codes of the C entry point (csrc/grouped_gemm.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TENSOR_CORE_TMS = (16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Tile-aligned padded layout. ``m_pad`` = round_up(num_rows, tm) +
    num_groups * tm, a static bound on the rows used."""

    tm: int
    m_pad: int
    num_rows: int
    expert_of_tile: torch.Tensor  # [m_pad // tm] int32, -1 past the used tiles
    src_row: torch.Tensor  # [m_pad] int64: group-sorted row feeding each row
    src_valid: torch.Tensor  # [m_pad] bool: a real row (not alignment padding)
    padded_pos: torch.Tensor  # [num_rows] int64: padded row of each sorted row


def make_group_layout(group_sizes: torch.Tensor, num_rows: int,
                      tm: int) -> GroupLayout:
    """The padded layout of ``num_rows`` rows sorted by group, group g
    holding ``group_sizes[g]`` of them (flashinfer_tpu/ops/gemm_grouped.py:
    94). Device tensor ops only; ``m_pad`` alone is static."""
    dev = group_sizes.device
    e = group_sizes.shape[0]
    gs = group_sizes.long()
    padded = (gs + tm - 1) // tm * tm
    pcum = torch.cumsum(padded, 0)
    pstart = pcum - padded
    cum = torch.cumsum(gs, 0)
    start = cum - gs
    used = pcum[-1]

    m_pad = round_up(num_rows, tm) + e * tm
    tile0 = torch.arange(m_pad // tm, device=dev) * tm
    eot = torch.searchsorted(pcum, tile0, right=True)
    eot = torch.where(tile0 < used, eot, -1).to(torch.int32)

    rows = torch.arange(m_pad, device=dev)
    er = torch.searchsorted(pcum, rows, right=True).clamp(max=e - 1)
    off = rows - pstart[er]
    src_valid = (rows < used) & (off < gs[er])
    src_row = torch.where(src_valid, start[er] + off, 0)

    srows = torch.arange(num_rows, device=dev)
    sg = torch.searchsorted(cum, srows, right=True).clamp(max=e - 1)
    padded_pos = pstart[sg] + (srows - start[sg])
    return GroupLayout(tm=tm, m_pad=m_pad, num_rows=num_rows,
                       expert_of_tile=eot, src_row=src_row,
                       src_valid=src_valid, padded_pos=padded_pos)


def _expert_scales(scales, e: int, device) -> torch.Tensor:
    if scales is None:
        return torch.ones(e, dtype=torch.float32, device=device)
    s = torch.as_tensor(scales, dtype=torch.float32, device=device)
    return s.reshape(-1).expand(e).contiguous()


def grouped_gemm_padded_plain(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    expert_of_tile: torch.Tensor,
    scales=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    rhs_nk: bool = False,
) -> torch.Tensor:
    """The grouped GEMM in plain PyTorch: a loop over the experts present,
    in f32; rows of -1 tiles are zero."""
    m_pad = lhs.shape[0]
    n = rhs.shape[1] if rhs_nk else rhs.shape[2]
    tm = m_pad // expert_of_tile.numel()
    scales = _expert_scales(scales, rhs.shape[0], lhs.device)
    row_e = expert_of_tile.long().repeat_interleave(tm)
    out = torch.zeros(m_pad, n, dtype=torch.float32, device=lhs.device)
    for e in torch.unique(row_e[row_e >= 0]).tolist():
        rows = torch.nonzero(row_e == e)[:, 0]
        w = rhs[e].float()
        out[rows] = (lhs[rows].float() @ (w.T if rhs_nk else w)) * scales[e]
    return out.to(out_dtype or lhs.dtype)


def _lib():
    fn = jit.load("grouped_gemm").fi_grouped_gemm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P,  # lhs rhs expert_of_tile scales out
                       I, I, I, I, I,  # m_pad K N tm num_experts
                       I, I, I, I, P]  # rhs_nk lhs/rhs/out dtypes stream
        fn.restype = I
    return fn


def grouped_gemm_padded(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    expert_of_tile: torch.Tensor,
    scales=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    rhs_nk: bool = False,
) -> torch.Tensor:
    """``out[p] = lhs[p] @ (rhs[e] * scales[e])`` for every padded row p of
    a tile owned by expert e (zeros for -1 tiles). lhs [m_pad, K]: bf16
    with bf16 or e4m3 weights, f32 with f32 weights; out [m_pad, N] in
    ``out_dtype`` (bf16 or f32; default lhs's).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``grouped_gemm_padded_plain``."""
    out_dtype = out_dtype or lhs.dtype
    if rhs.dtype not in _CODES:
        raise TypeError(f"grouped GEMM weights must be f32, bf16 or e4m3, "
                        f"got {rhs.dtype}")
    want_lhs = torch.float32 if rhs.dtype == torch.float32 else torch.bfloat16
    if lhs.dtype != want_lhs:
        raise TypeError(f"{rhs.dtype} weights take {want_lhs} rows, got "
                        f"{lhs.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if not lhs.is_cuda:
        return grouped_gemm_padded_plain(lhs, rhs, expert_of_tile, scales,
                                         out_dtype=out_dtype, rhs_nk=rhs_nk)
    m_pad, k = lhs.shape
    e = rhs.shape[0]
    n, kr = (rhs.shape[1], rhs.shape[2]) if rhs_nk else (rhs.shape[2],
                                                        rhs.shape[1])
    mt = expert_of_tile.numel()
    if kr != k or mt == 0 or m_pad % mt:
        raise ValueError(f"lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} "
                         f"(rhs_nk={rhs_nk}) and {mt} tiles do not fit")
    tm = m_pad // mt
    if rhs.dtype != torch.float32 and (tm not in TENSOR_CORE_TMS or k % 32
                                       or n % 16):
        raise ValueError(f"the tensor-core grouped GEMM takes tm in "
                         f"{TENSOR_CORE_TMS}, K % 32 == 0 and N % 16 == 0; "
                         f"got tm={tm}, K={k}, N={n}")
    for t, name in ((lhs, "lhs"), (rhs, "rhs"),
                    (expert_of_tile, "expert_of_tile")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if expert_of_tile.dtype != torch.int32:
        raise TypeError("expert_of_tile must be int32")
    sc = _expert_scales(scales, e, lhs.device)
    out = torch.empty(m_pad, n, dtype=out_dtype, device=lhs.device)
    err = _lib()(
        lhs.data_ptr(), rhs.data_ptr(), expert_of_tile.data_ptr(),
        sc.data_ptr(), out.data_ptr(), m_pad, k, n, tm, e, int(rhs_nk),
        _CODES[lhs.dtype], _CODES[rhs.dtype], _CODES[out_dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    jit.check(err, "grouped GEMM kernel")
    grouped_gemm_padded.launches += 1
    return out


grouped_gemm_padded.launches = 0


def grouped_gemm(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_sizes: torch.Tensor,
    scales=None,
    *,
    tm: int = 128,
    out_dtype: Optional[torch.dtype] = None,
    rhs_nk: bool = False,
) -> torch.Tensor:
    """``lax.ragged_dot`` semantics (rows sorted by group) on the grouped
    kernel: build the padded layout, run the GEMM, gather the real rows
    back (flashinfer_tpu/ops/gemm_grouped.py:331). bf16 or e4m3 weights
    take the rows in bf16."""
    num_rows = lhs.shape[0]
    layout = make_group_layout(group_sizes, num_rows, tm)
    x = lhs[layout.src_row]
    x = torch.where(layout.src_valid[:, None], x, 0)
    if rhs.dtype != torch.float32:
        x = x.to(torch.bfloat16)
    out = grouped_gemm_padded(x, rhs, layout.expert_of_tile, scales,
                              out_dtype=out_dtype or lhs.dtype,
                              rhs_nk=rhs_nk)
    return out[layout.padded_pos]
