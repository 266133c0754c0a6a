"""Cascade (multi-level shared-prefix) attention: counterpart of
``flashinfer_tpu/ops/attention/cascade.py``.

Requests that share a prefix attend to its KV once a group at the upper
levels and to their own suffix at the last level; each level is one planned
``BatchAttention`` (the paged kernel), and the levels' (o, lse) states fold
together with ``merge_state``. The merge is plain PyTorch, as JAX's is
(``state.py``, outside any Pallas kernel).

The levels' plans take what ``BatchAttention.plan`` takes: any page size
(small pages repacked at ``run()``) and ``kv_chunk_size`` None (the
library's choice) among them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from flashinfer_tpu_torch.ops.attention.batch import BatchAttention
from flashinfer_tpu_torch.ops.attention.state import (
    merge_state,
    merge_state_in_place,
    merge_states,
)

__all__ = [
    "MultiLevelCascadeAttentionWrapper",
    "merge_state",
    "merge_states",
    "merge_state_in_place",
]


class MultiLevelCascadeAttentionWrapper:
    """Multi-level cascade attention over one shared paged KV cache.

    Levels run top (the most shared prefix) to bottom (each request's own
    suffix). ``causal`` and ``window_left`` apply at the last level only:
    the upper levels hold keys strictly before every query of their group.
    The logits soft cap applies at every level, as in JAX."""

    def __init__(self, num_levels: int, kv_layout: str = "HND",
                 **wrapper_kw):
        self._num_levels = num_levels
        self._wrappers = [BatchAttention(kv_layout=kv_layout, **wrapper_kw)
                          for _ in range(num_levels)]

    @property
    def levels(self) -> Sequence[BatchAttention]:
        """The planned wrapper of each level, top first."""
        return tuple(self._wrappers)

    def plan(
        self,
        qo_indptr_arr: Sequence[np.ndarray],
        paged_kv_indptr_arr: Sequence[np.ndarray],
        paged_kv_indices_arr: Sequence[np.ndarray],
        paged_kv_last_page_len_arr: Sequence[np.ndarray],
        num_qo_heads: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int,
        *,
        causal: bool = True,
        sm_scale: Optional[float] = None,
        window_left: int = -1,
        logits_soft_cap: float = 0.0,
        **kwargs,
    ) -> "MultiLevelCascadeAttentionWrapper":
        """One host index set a level (``BatchAttention.plan``'s qo_indptr,
        kv_indptr, kv_indices and kv_last_page_len); ``kwargs`` go to every
        level's plan (``kv_chunk_size`` among them; None leaves it to the
        library)."""
        if len(qo_indptr_arr) != self._num_levels:
            raise ValueError(f"{len(qo_indptr_arr)} index sets for "
                             f"{self._num_levels} levels")
        for lvl, w in enumerate(self._wrappers):
            last_level = lvl == self._num_levels - 1
            w.plan(qo_indptr_arr[lvl], paged_kv_indptr_arr[lvl],
                   paged_kv_indices_arr[lvl], paged_kv_last_page_len_arr[lvl],
                   num_qo_heads, num_kv_heads, head_dim, page_size,
                   causal=causal and last_level, sm_scale=sm_scale,
                   window_left=window_left if last_level else -1,
                   logits_soft_cap=logits_soft_cap, **kwargs)
        return self

    def run(self, q: torch.Tensor, paged_kv_cache, *,
            return_lse: bool = False, **kwargs):
        """q [nnz, num_qo_heads, head_dim]; every level reads the same
        (k, v) cache. Returns o [nnz, heads, head_dim] (and lse [nnz, heads]
        f32, natural log, with ``return_lse``)."""
        v_merged = s_merged = None
        for w in self._wrappers:
            out, lse = w.run(q, paged_kv_cache, return_lse=True, **kwargs)
            if v_merged is None:
                v_merged, s_merged = out, lse
            else:
                v_merged, s_merged = merge_state(v_merged, s_merged, out, lse)
        if return_lse:
            return v_merged, s_merged
        return v_merged
