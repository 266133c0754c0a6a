"""GEMM family: segment GEMM and the fp8 / fp4 matmuls (counterpart of
``flashinfer_tpu/ops/gemm.py``).

The quantized matmuls follow JAX's arithmetic: decode each operand with its
scales folded in (e4m3 through ``ops.fp8``'s bit decode, e2m1 through
``ops.fp4``), then one product accumulated in f32. A dense product is a
plain ``torch.matmul`` in f32 (the JAX package leaves it to XLA, outside
any Pallas kernel; bf16 operands multiply exactly in f32). The grouped
products (``SegmentGEMMWrapper``, ``group_gemm_fp8_nt_groupwise``,
``group_gemm_mxfp4_nt_groupwise``) have ``lax.ragged_dot`` semantics, rows
sorted by group, and run the port's grouped GEMM (``ops.gemm_grouped.
grouped_gemm``): its CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from flashinfer_tpu_torch.ops.fp4 import fp4_dequantize
from flashinfer_tpu_torch.ops.fp8 import fp8_to_bf16
from flashinfer_tpu_torch.ops.fused_moe import select_moe_tm
from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm
from flashinfer_tpu_torch.utils import cdiv

__all__ = [
    "SegmentGEMMWrapper",
    "bmm_fp8",
    "mm_fp4",
    "gemm_fp8_nt_groupwise",
    "group_gemm_fp8_nt_groupwise",
    "group_gemm_mxfp4_nt_groupwise",
    "tgv_gemm",
]


def _ragged_dot(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                out_dtype: torch.dtype, *, w_nk: bool = False) -> torch.Tensor:
    """``lax.ragged_dot(x, w, group_sizes)`` accumulated in f32, cast to
    ``out_dtype``: rows sorted by group, group g times ``w[g]`` ([K, N], or
    [N, K] with ``w_nk``), on the grouped GEMM."""
    group_sizes = torch.as_tensor(group_sizes, device=x.device)
    tm = select_moe_tm(x.shape[0], w.shape[0])
    out = grouped_gemm(x, w, group_sizes, tm=tm, out_dtype=torch.float32,
                       rhs_nk=w_nk)
    return out.to(out_dtype)


class SegmentGEMMWrapper:
    """Segment GEMM for LoRA-style workloads: the rows of ``x`` come in
    segments, and segment i multiplies ``weights[weight_indices[i]]``
    (flashinfer_tpu/ops/gemm.py:48)."""

    def __init__(self, float_workspace_buffer=None, backend: str = "auto"):
        del float_workspace_buffer, backend  # the kernel takes no scratch

    def run(self, x: torch.Tensor, weights: torch.Tensor, batch_size: int,
            weight_column_major: bool, *,
            seg_lens: Optional[torch.Tensor] = None,
            seg_indptr: Optional[torch.Tensor] = None,
            weight_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [total_rows, k]; weights [num_weights, k, n], or [num_weights,
        n, k] with ``weight_column_major``. Returns [total_rows, n] in x's
        dtype, accumulated in f32."""
        if seg_lens is None:
            if seg_indptr is None:
                raise ValueError("give seg_lens or seg_indptr")
            seg_indptr = torch.as_tensor(seg_indptr, device=x.device)
            seg_lens = seg_indptr[1:] - seg_indptr[:-1]
        if weight_indices is not None:
            weights = weights[torch.as_tensor(weight_indices,
                                              device=weights.device).long()]
        if weights.dtype != x.dtype:
            weights = weights.to(x.dtype)
        return _ragged_dot(x, weights.contiguous(), seg_lens, x.dtype,
                           w_nk=weight_column_major)

    forward = run


def bmm_fp8(A: torch.Tensor, B: torch.Tensor, A_scale, B_scale,
            dtype: torch.dtype = torch.bfloat16, out: None = None
            ) -> torch.Tensor:
    """Batched fp8 matmul with per-tensor scales: (A @ B) * A_scale *
    B_scale. A [b, m, k], B [b, k, n]: e4m3 (or another dtype, cast)."""
    del out
    acc = torch.matmul(fp8_to_bf16(A).float(), fp8_to_bf16(B).float())
    scale = (torch.as_tensor(A_scale, dtype=torch.float32, device=acc.device)
             * torch.as_tensor(B_scale, dtype=torch.float32,
                               device=acc.device))
    return (acc * scale).to(dtype)


def mm_fp4(a: torch.Tensor, b: torch.Tensor, a_descale: torch.Tensor,
           b_descale: torch.Tensor, alpha: Optional[torch.Tensor] = None,
           out_dtype: torch.dtype = torch.bfloat16, block_size: int = 16,
           use_8x4_sf_layout: bool = False, **_compat) -> torch.Tensor:
    """FP4 matmul, NT layout: a [m, k / 2] and b [n, k / 2] packed e2m1
    with e4m3 block scales every ``block_size`` elements."""
    a_f = fp4_dequantize(a, a_descale, sf_vec_size=block_size,
                         dtype=torch.bfloat16)
    b_f = fp4_dequantize(b, b_descale, sf_vec_size=block_size,
                         dtype=torch.bfloat16)
    acc = a_f.float() @ b_f.float().T
    if alpha is not None:
        acc = acc * torch.as_tensor(alpha, dtype=torch.float32,
                                    device=acc.device)
    return acc.to(out_dtype)


def gemm_fp8_nt_groupwise(a: torch.Tensor, b: torch.Tensor,
                          a_scale: torch.Tensor, b_scale: torch.Tensor,
                          scale_granularity_mnk: Sequence[int] = (1, 128, 128),
                          out_dtype: torch.dtype = torch.bfloat16, *,
                          interpret: Optional[bool] = None, **_compat
                          ) -> torch.Tensor:
    """Groupwise-scaled fp8 GEMM, NT layout: a [m, k] e4m3 with a_scale
    [m, k / gk] (per row and k-block), b [n, k] e4m3 with b_scale
    [k / gk, n / gn]. Each operand is decoded with its scales folded in and
    rounded to bf16, then one f32 product."""
    del interpret
    m, k = a.shape
    n, k2 = b.shape
    _, _, gk = scale_granularity_mnk
    if k != k2 or k % gk or b_scale.shape[0] != k // gk \
            or n % b_scale.shape[1]:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, b_scale "
                         f"{tuple(b_scale.shape)} and gk {gk} do not fit")
    a_full = a_scale.float().repeat_interleave(gk, dim=1)[:, :k]
    b_full = (b_scale.float().repeat_interleave(gk, dim=0)[:k]
              .repeat_interleave(n // b_scale.shape[1], dim=1)[:, :n])
    a_deq = (fp8_to_bf16(a).float() * a_full).to(torch.bfloat16)
    b_deq = (fp8_to_bf16(b).float() * b_full.T).to(torch.bfloat16)
    return (a_deq.float() @ b_deq.float().T).to(out_dtype)


def _group_sizes(m_indptr) -> torch.Tensor:
    m_indptr = torch.as_tensor(m_indptr)
    return (m_indptr[1:] - m_indptr[:-1]).to(torch.int32)


def _rows_deq(a: torch.Tensor, a_scale: torch.Tensor, bk: int = 128
              ) -> torch.Tensor:
    """Rowwise-blockwise fp8 rows, decoded and scaled in f32."""
    rows, k = a.shape
    a_f = fp8_to_bf16(a).float().reshape(rows, k // bk, bk)
    return (a_f * a_scale.float()[:, :, None]).reshape(rows, k)


def group_gemm_fp8_nt_groupwise(a: torch.Tensor, b: torch.Tensor,
                                a_scale: torch.Tensor, b_scale: torch.Tensor,
                                m_indptr,
                                scale_granularity_mnk: Sequence[int] = (
                                    1, 128, 128),
                                out_dtype: torch.dtype = torch.bfloat16,
                                **_compat) -> torch.Tensor:
    """Grouped fp8 GEMM: rows of ``a`` grouped by ``m_indptr``, group g
    times ``b[g]``. a [total_m, k] e4m3, a_scale [total_m, k / 128]; b
    [g, n, k] e4m3, b_scale [g, k / 128, n / 128]."""
    g, n, k = b.shape
    bk = 128
    a_f = _rows_deq(a, a_scale, bk).to(torch.bfloat16)
    gn = cdiv(n, b_scale.shape[2])
    bs = b_scale.float().repeat_interleave(gn, dim=2)[:, :, :n]
    b_f = fp8_to_bf16(b).float().reshape(g, n, k // bk, bk)
    b_f = (b_f * bs.transpose(1, 2)[:, :, :, None]).reshape(g, n, k)
    return _ragged_dot(a_f, b_f.to(torch.bfloat16), _group_sizes(m_indptr),
                       out_dtype, w_nk=True)


def group_gemm_mxfp4_nt_groupwise(a: torch.Tensor, b: torch.Tensor,
                                  a_scale: torch.Tensor,
                                  b_scale: torch.Tensor, m_indptr,
                                  out_dtype: torch.dtype = torch.bfloat16,
                                  **_compat) -> torch.Tensor:
    """Grouped GEMM with mxfp4 weights: a [total_m, k] e4m3 rowwise-scaled
    (a_scale [total_m, k / 128]); b [g, n, k / 2] packed e2m1 with e8m0
    scales b_scale [g, n, k / 32]."""
    a_f = _rows_deq(a, a_scale).to(torch.bfloat16)
    b_f = fp4_dequantize(b, b_scale, sf_vec_size=32, sf_use_ue8m0=True,
                         dtype=torch.bfloat16)
    return _ragged_dot(a_f, b_f.contiguous(), _group_sizes(m_indptr),
                       out_dtype, w_nk=True)


def tgv_gemm(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None, pdl: bool = False
             ) -> torch.Tensor:
    """Small-batch GEMM + bias: (a @ b + bias) accumulated in f32, in a's
    dtype."""
    out = a.float() @ b.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(a.dtype)
