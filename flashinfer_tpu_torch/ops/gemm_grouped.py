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
read in place with no transposed copy. bf16, f32, ``float8_e4m3fn`` (the
JAX package's int8 containers of e4m3 bits are the same bytes:
``.view(torch.float8_e4m3fn)``) or linear int8. Scales are one f32 an
expert, or one an output column of each expert ([E, N]). e4m3 converts
exactly (the MoE path), or with ``e4m3_ftz`` through the JAX package's bit
decode (``ops.fp8.e4m3_bits_to_bf16``: denormals to zero, the dense 8-bit
matmul). Its K-permutation for the TPU bit decode (``fp8_k_permutation``)
has no counterpart here: the card converts 8-bit weights to bf16 in
registers on their way into the tensor cores. The tensor-core kernel reads
through TMA, so its tensors start on 16-byte boundaries (PyTorch's
allocations do).

``w8_matmul`` is the JAX engine's ``_wmm`` (flashinfer_tpu/serving/
engine.py:904) on this kernel: one group, per-output-column scales.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.ops.fp8 import e4m3_bits_to_bf16
from flashinfer_tpu_torch.utils import cdiv, round_up

__all__ = [
    "GroupLayout",
    "make_group_layout",
    "grouped_gemm_padded",
    "grouped_gemm_padded_plain",
    "grouped_gemm",
    "w8_matmul",
    "w8_matmul_plain",
]

# dtype codes of the C entry point (csrc/grouped_gemm.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
          torch.int8: 3}
_E4M3_FTZ = 4  # e4m3 through the bit decode
_W8 = (torch.float8_e4m3fn, torch.int8)
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


def _scale_table(scales, e: int, n: int, device) -> Tuple[torch.Tensor,
                                                          bool]:
    """(the f32 scales, whether they are per column): [E, N] per output
    column when ``scales`` has that shape, else one an expert, [E]."""
    if scales is None:
        return torch.ones(e, dtype=torch.float32, device=device), False
    s = torch.as_tensor(scales, dtype=torch.float32, device=device)
    if s.shape == (e, n):
        return s.contiguous(), True
    return s.reshape(-1).expand(e).contiguous(), False


def _tiles(lhs, expert_of_tile, tm) -> Tuple[int, int]:
    """(tm, number of m-tiles): ``tm`` given, or m_pad // tiles with lhs's
    rows as m_pad."""
    if expert_of_tile is None:
        if tm is None:
            raise ValueError("a call without expert_of_tile names its tm")
        return tm, cdiv(lhs.shape[0], tm)
    mt = expert_of_tile.numel()
    return tm or lhs.shape[0] // max(mt, 1), mt


def grouped_gemm_padded_plain(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    expert_of_tile: Optional[torch.Tensor],
    scales=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    rhs_nk: bool = False,
    e4m3_ftz: bool = False,
    tm: Optional[int] = None,
) -> torch.Tensor:
    """The grouped GEMM in plain PyTorch: a loop over the experts present,
    in f32; rows of -1 tiles are zero."""
    rows = lhs.shape[0]
    n = rhs.shape[1] if rhs_nk else rhs.shape[2]
    tm, mt = _tiles(lhs, expert_of_tile, tm)
    scales, _ = _scale_table(scales, rhs.shape[0], n, lhs.device)
    eot = (torch.zeros(mt, dtype=torch.long, device=lhs.device)
           if expert_of_tile is None else expert_of_tile.long())
    row_e = eot.repeat_interleave(tm)[:rows]
    out = torch.zeros(rows, n, dtype=torch.float32, device=lhs.device)
    for e in torch.unique(row_e[row_e >= 0]).tolist():
        sel = torch.nonzero(row_e == e)[:, 0]
        w = _w8_decode(rhs[e], torch.float32) if e4m3_ftz else rhs[e].float()
        out[sel] = (lhs[sel].float() @ (w.T if rhs_nk else w)) * scales[e]
    return out.to(out_dtype or lhs.dtype)


def _lib():
    fn = jit.load("grouped_gemm").fi_grouped_gemm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P,  # lhs rhs expert_of_tile scales out
                       I, I, I, I, I, I,  # m_pad rows K N tm num_experts
                       I, I, I, I,  # rhs_nk lhs/rhs/out dtypes
                       I, I, I, P, P,  # col_scales splits k_tiles_split ws
                       P]  # sem stream
        fn.restype = I
    return fn


_sems: Dict[torch.device, torch.Tensor] = {}


def _tile_n(tm: int, w_dtype: torch.dtype, rhs_nk: bool) -> int:
    """Output columns a CTA of the tensor-core kernel (its ``Geo``)."""
    return 256 if tm >= 64 or (w_dtype in _W8 and not rhs_nk) else 128


def _split_k(tiles: int, k: int, ctas: int, device: torch.device
             ) -> Tuple[int, int]:
    """(splits, 64-deep stages a split): split K when the tiles alone
    cannot fill the card (a dense matmul of few output columns at decode:
    16 tiles for a 4096-wide output), to about one CTA a slot (``ctas``
    an SM: two with 128-column tiles, one with 256), every split at least
    4 stages."""
    slots = _sm_count(device) * ctas
    k_tiles = cdiv(k, 64)
    splits = max(1, min(k_tiles // 4, slots // max(tiles, 1)))
    per = cdiv(k_tiles, splits)
    return cdiv(k_tiles, per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tile_semaphores(tiles: int, device: torch.device) -> torch.Tensor:
    """The split-K arrival counters, one a tile: zeros, and zero again after
    every launch (the last split resets its tile's). One buffer a device,
    grown outside a CUDA graph capture only."""
    sem = _sems.get(device)
    if sem is None or sem.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("grouped GEMM: split-K counters must exist "
                               "before a capture; run the call once first")
        sem = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _sems[device] = sem
    return sem


def grouped_gemm_padded(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    expert_of_tile: Optional[torch.Tensor],
    scales=None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    rhs_nk: bool = False,
    e4m3_ftz: bool = False,
    tm: Optional[int] = None,
) -> torch.Tensor:
    """``out[p] = (lhs[p] @ rhs[e]) * scales[e]`` for every padded row p of
    a tile owned by expert e (zeros for -1 tiles). lhs [m_pad, K]: bf16
    with bf16 or 8-bit weights, f32 with f32 or 8-bit weights; out [m_pad,
    N] in ``out_dtype`` (bf16 or f32; default lhs's). ``scales``: one an
    expert, or [E, N], one an output column. ``e4m3_ftz``: e4m3 weights
    through ``ops.fp8.e4m3_bits_to_bf16`` (denormals to zero) rather than
    converted exactly.

    With ``tm`` given, lhs may hold fewer rows than the tiles cover: the
    rows past it read as zeros and out has lhs's rows. Without
    ``expert_of_tile`` (None) every tile is expert 0 and ``tm`` is needed.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``grouped_gemm_padded_plain``."""
    out_dtype = out_dtype or lhs.dtype
    if rhs.dtype not in _CODES:
        raise TypeError(f"grouped GEMM weights must be f32, bf16, e4m3 or "
                        f"int8, got {rhs.dtype}")
    want_lhs = ((torch.float32, torch.bfloat16) if rhs.dtype in _W8 else
                (torch.float32,) if rhs.dtype == torch.float32 else
                (torch.bfloat16,))
    if lhs.dtype not in want_lhs:
        raise TypeError(f"{rhs.dtype} weights take {want_lhs} rows, got "
                        f"{lhs.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if not lhs.is_cuda:
        return grouped_gemm_padded_plain(
            lhs, rhs, expert_of_tile, scales, out_dtype=out_dtype,
            rhs_nk=rhs_nk, e4m3_ftz=e4m3_ftz, tm=tm)
    rows, k = lhs.shape
    e = rhs.shape[0]
    n, kr = (rhs.shape[1], rhs.shape[2]) if rhs_nk else (rhs.shape[2],
                                                        rhs.shape[1])
    tm_given = tm is not None
    tm, mt = _tiles(lhs, expert_of_tile, tm)
    m_pad = mt * tm
    if (kr != k or mt == 0 or rows > m_pad
            or (not tm_given and rows != m_pad)):
        raise ValueError(f"lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} "
                         f"(rhs_nk={rhs_nk}) and {mt} tiles do not fit")
    if lhs.dtype == torch.bfloat16 and (tm not in TENSOR_CORE_TMS or k % 32
                                        or n % 16):
        raise ValueError(f"the tensor-core grouped GEMM takes tm in "
                         f"{TENSOR_CORE_TMS}, K % 32 == 0 and N % 16 == 0; "
                         f"got tm={tm}, K={k}, N={n}")
    for t, name in ((lhs, "lhs"), (rhs, "rhs"),
                    (expert_of_tile, "expert_of_tile")):
        if t is not None and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if expert_of_tile is not None and expert_of_tile.dtype != torch.int32:
        raise TypeError("expert_of_tile must be int32")
    sc, col = _scale_table(scales, e, n, lhs.device)
    code = (_E4M3_FTZ if e4m3_ftz and rhs.dtype == torch.float8_e4m3fn
            else _CODES[rhs.dtype])
    out = torch.empty(rows, n, dtype=out_dtype, device=lhs.device)
    splits, per, ws, sem = 1, 0, None, None
    if lhs.dtype == torch.bfloat16:
        tile_n = _tile_n(tm, rhs.dtype, rhs_nk)
        tiles = mt * cdiv(n, tile_n)
        splits, per = _split_k(tiles, k, 2 if tile_n == 128 else 1,
                               lhs.device)
        if splits > 1:
            ws = torch.empty(splits * tiles * tm * tile_n,
                             dtype=torch.float32, device=lhs.device)
            sem = _tile_semaphores(tiles, lhs.device)
    err = _lib()(
        lhs.data_ptr(), rhs.data_ptr(),
        None if expert_of_tile is None else expert_of_tile.data_ptr(),
        sc.data_ptr(), out.data_ptr(), m_pad, rows, k, n, tm, e,
        int(rhs_nk), _CODES[lhs.dtype], code, _CODES[out_dtype], int(col),
        splits, per, None if ws is None else ws.data_ptr(),
        None if sem is None else sem.data_ptr(),
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


def _w8_decode(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """8-bit weights as ``dtype``: e4m3 through the bit decode (to bf16
    first, as JAX's ``_wmm``), linear int8 by a cast (exact)."""
    if w.dtype == torch.float8_e4m3fn:
        return e4m3_bits_to_bf16(w.view(torch.int8)).to(dtype)
    return w.to(dtype)


def w8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``w8_matmul`` in plain PyTorch, as JAX's ``_wmm`` computes it: the
    product in x's dtype, then the scale on its f32 value, rounded once
    more to x's dtype."""
    y = x @ _w8_decode(w, x.dtype)
    return (y.float() * scale).to(x.dtype)


def w8_tm(rows: int) -> int:
    """The m-tile of a dense 8-bit matmul of ``rows`` rows."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 128


def w8_matmul(x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``(x @ decode(w)) * scale`` for 8-bit weights with per-output-channel
    scales, the JAX engine's ``_wmm`` (flashinfer_tpu/serving/engine.py:
    904). x [rows, K] bf16 or f32; w [K, N] ``float8_e4m3fn`` (decoded as
    ``ops.fp8.e4m3_bits_to_bf16``) or linear int8; scale [1, N] (or [N])
    f32. Returns [rows, N] in x's dtype.

    On a CUDA tensor: one launch of the grouped GEMM as one group (every
    m-tile expert 0, tm 16 / 32 / 128 by row count), the scales applied to
    the f32 accumulator; the rows are not padded (the kernel reads zeros
    past them and stores only them), and nothing reads back to the host,
    so the call captures into a CUDA graph. bf16 rows need K % 32 == 0 and
    N % 16 == 0. A CPU tensor takes ``w8_matmul_plain``."""
    if w.dtype not in _W8:
        raise TypeError(f"w8_matmul takes float8_e4m3fn or int8 weights, "
                        f"got {w.dtype}")
    if not x.is_cuda:
        return w8_matmul_plain(x, w, scale)
    n = w.shape[-1]
    if scale.numel() != n:
        raise ValueError(f"scale {tuple(scale.shape)} does not fit "
                         f"{n} output columns")
    return grouped_gemm_padded(
        x, w[None], None, scale.reshape(1, n), out_dtype=x.dtype,
        e4m3_ftz=True, tm=w8_tm(x.shape[0]))
