"""Block-sparse and variable-block-sparse attention (counterpart of
``flashinfer_tpu/ops/attention/sparse.py``).

As in JAX, both run the paged kernel. A dense K [N, h, d] reshaped in place
to [N / C, C, h, d] is an NHD paged cache whose page table is the BSR column
index array, so ``BlockSparseAttentionWrapper`` plans each row of blocks as
a request whose pages are its column blocks. Variable block sizes become
page-size-1 token indices (the reference's vector-sparse conversion), which
``BatchAttention`` repacks into 128-token pages at ``run()``; so do blocks
narrower than 8 columns (JAX's rule; wider ones are read in place).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flashinfer_tpu_torch.ops.attention.batch import BatchAttention, _host

__all__ = [
    "BlockSparseAttentionWrapper",
    "VariableBlockSparseAttentionWrapper",
]


class BlockSparseAttentionWrapper(BatchAttention):
    """BSR attention: M x N sparsity in fixed (R, C) blocks."""

    def __init__(self, float_workspace_buffer=None, backend: str = "auto",
                 **kw):
        super().__init__(kv_layout="NHD", backend=backend, **kw)
        self._C = None

    def plan(self, indptr, indices, M: int, N: int, R: int, C: int,
             num_qo_heads: int, num_kv_heads: int, head_dim: int, *,
             mask=None, sm_scale: Optional[float] = None, **kwargs):
        """indptr / indices: BSR over (M / R) x (N / C) blocks. Each row of
        blocks becomes one planned request whose pages are its column
        blocks (not causal: the pattern is the mask; ``mask`` is accepted
        and unread, as in JAX)."""
        if M % R or N % C:
            raise ValueError(f"M={M}, N={N} are not multiples of R={R}, "
                             f"C={C}")
        indptr = _host(indptr, np.int64)
        mb = M // R
        if len(indptr) != mb + 1:
            raise ValueError(f"indptr has {len(indptr)} entries for {mb} "
                             f"rows of blocks")
        self._C = C
        return super().plan(
            np.arange(mb + 1) * R, indptr, _host(indices, np.int64),
            np.full(mb, C, np.int64), num_qo_heads, num_kv_heads, head_dim,
            page_size=C, causal=False, sm_scale=sm_scale, **kwargs)

    def run(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            **kwargs):
        """q [M, hq, d]; k / v [N, hkv, d] dense, viewed (no copy) as the
        NHD pages [N / C, C, hkv, d]."""
        C = self._C
        return super().run(q, (k.reshape(k.shape[0] // C, C, *k.shape[1:]),
                               v.reshape(v.shape[0] // C, C, *v.shape[1:])),
                           **kwargs)


class VariableBlockSparseAttentionWrapper(BatchAttention):
    """Sparse attention in blocks of varying extents: ``block_row_sz`` /
    ``block_col_sz`` give each block row's and column's tokens."""

    def __init__(self, float_workspace_buffer=None, backend: str = "auto",
                 **kw):
        super().__init__(kv_layout="NHD", backend=backend, **kw)

    def plan(self, block_mask_map, block_row_sz, block_col_sz,
             num_qo_heads: int, num_kv_heads: int, head_dim: int, *,
             sm_scale: Optional[float] = None, **kwargs):
        """block_mask_map [MB, NB] bool: which (row block, column block)
        pairs attend. Each row block is a request whose keys are the tokens
        of its column blocks, as page-size-1 indices."""
        block_mask_map = _host(block_mask_map).astype(bool)
        block_row_sz = _host(block_row_sz, np.int64)
        block_col_sz = _host(block_col_sz, np.int64)
        col_starts = np.concatenate([[0], np.cumsum(block_col_sz)])
        tokens = [np.concatenate([np.arange(col_starts[c], col_starts[c + 1])
                                  for c in np.nonzero(row)[0]] or
                                 [np.zeros(0, np.int64)])
                  for row in block_mask_map]
        kv_indptr = np.concatenate([[0], np.cumsum([len(t) for t in tokens])])
        return super().plan(
            np.concatenate([[0], np.cumsum(block_row_sz)]), kv_indptr,
            np.concatenate(tokens) if tokens else np.zeros(0, np.int64),
            np.ones(len(tokens), np.int64), num_qo_heads, num_kv_heads,
            head_dim, page_size=1, causal=False, sm_scale=sm_scale, **kwargs)

    def run(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            **kwargs):
        """q [M, hq, d]; k / v [N, hkv, d] dense, as pages of one token."""
        return super().run(q, (k[:, None], v[:, None]), **kwargs)
