"""POD attention: one chunked-prefill request beside a batch of decodes
(counterpart of ``flashinfer_tpu/ops/attention/pod.py``).

Two modes, chosen at ``plan``:

- two launches (no ``prefill_page_indices``): the prefill runs on its dense
  KV through ``single_prefill_with_kv_cache`` (the flash kernel) and the
  decodes through the paged kernel;
- combined (``prefill_page_indices`` given): ``run`` first appends the
  prefill's KV into those pages of the paged cache, then one plan holds the
  prefill's tiles and the decodes, and one paged-kernel launch serves both.
  The append is in place: ``run`` returns the same cache tensors, mutated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from flashinfer_tpu_torch.ops.attention.batch import BatchAttention
from flashinfer_tpu_torch.ops.attention.single import (
    single_prefill_with_kv_cache,
)
from flashinfer_tpu_torch.ops.page import append_paged_kv_cache

__all__ = ["PODWithPagedKVCacheWrapper"]


class PODWithPagedKVCacheWrapper:
    """One prefill + a decode batch under one plan."""

    def __init__(self, float_workspace_buffer=None, kv_layout: str = "HND",
                 backend: str = "auto", **kw):
        self._attn = BatchAttention(kv_layout=kv_layout, backend=backend,
                                    **kw)
        self._device = self._attn._device
        self._layout = kv_layout
        self._backend = backend
        self._combined = False

    def plan(
        self,
        indptr,
        indices,
        last_page_len,
        num_qo_heads: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int,
        *,
        kv_chunk_size: Optional[int] = None,
        sm_scale: Optional[float] = None,
        window_left: int = -1,
        logits_soft_cap: float = 0.0,
        prefill_qo_len: Optional[int] = None,
        prefill_kv_len: Optional[int] = None,
        prefill_page_indices: Optional[Sequence[int]] = None,
        causal_p: bool = True,
        kv_len_arr=None,
        **kwargs,
    ):
        """Plan the decode batch (host arrays); with
        ``prefill_page_indices``, plan the prefill request into the same
        work list. ``kv_chunk_size`` (None: the library's choice) and the
        other ``kwargs`` go to ``BatchAttention.plan``."""
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        last_page_len = np.asarray(last_page_len, np.int64)
        batch = len(indptr) - 1
        self._page_size = page_size
        self._combined = prefill_page_indices is not None
        common = dict(sm_scale=sm_scale, window_left=window_left,
                      logits_soft_cap=logits_soft_cap,
                      kv_chunk_size=kv_chunk_size, **kwargs)
        if self._combined:
            if prefill_qo_len is None or prefill_kv_len is None:
                raise ValueError("combined mode needs prefill_qo_len and "
                                 "prefill_kv_len")
            need = -(-prefill_kv_len // page_size)
            p_pages = np.asarray(prefill_page_indices, np.int64)
            if len(p_pages) < need:
                raise ValueError(f"{len(p_pages)} prefill pages for "
                                 f"{need} needed")
            p_pages = p_pages[:need]
            self._prefill_shape = (int(prefill_qo_len), int(prefill_kv_len))
            self._prefill_pages = torch.from_numpy(
                p_pages.astype(np.int32)).to(self._device)
            qo_indptr = np.concatenate(
                [[0, prefill_qo_len], prefill_qo_len + np.arange(1, batch + 1)])
            kv_lens = None
            if kv_len_arr is not None:
                kv_lens = np.concatenate(
                    [[prefill_kv_len], np.asarray(kv_len_arr, np.int64)])
            self._attn.plan(
                qo_indptr, np.concatenate([[0], need + indptr]),
                np.concatenate([p_pages, indices]),
                np.concatenate([[(prefill_kv_len - 1) % page_size + 1],
                                last_page_len]),
                num_qo_heads, num_kv_heads, head_dim, page_size,
                causal=causal_p, kv_len_arr=kv_lens, **common)
        else:
            self._attn.plan(
                np.arange(batch + 1), indptr, indices, last_page_len,
                num_qo_heads, num_kv_heads, head_dim, page_size,
                causal=False, kv_len_arr=kv_len_arr, **common)
        self._prefill_cfg = dict(sm_scale=sm_scale, window_left=window_left,
                                 logits_soft_cap=logits_soft_cap)
        return self

    def run(
        self,
        q_p: torch.Tensor,  # [qo_len, h, d] prefill queries
        k_p: torch.Tensor,  # [kv_len, hkv, d] prefill dense KV
        v_p: torch.Tensor,
        q_d: torch.Tensor,  # [batch, h, d] decode queries
        paged_kv_cache,
        *,
        causal_p: bool = True,
        return_lse: bool = False,
        **kwargs,
    ):
        """Combined mode: returns ((prefill_out, decode_out), cache), the
        cache being the one passed in, now holding the prefill's KV.
        Two-launch mode: returns (prefill_out, decode_out). With
        ``return_lse`` a pair of lses follows. ``kwargs`` (k_scale,
        v_scale) go to ``BatchAttention.run``."""
        if self._combined:
            qo_len, kv_len = self._prefill_shape
            if q_p.shape[0] != qo_len or k_p.shape[0] != kv_len:
                raise ValueError(f"prefill q {q_p.shape[0]} / kv "
                                 f"{k_p.shape[0]} rows, planned {qo_len} / "
                                 f"{kv_len}")
            dev = q_p.device
            npg = self._prefill_pages.numel()
            append_paged_kv_cache(
                k_p, v_p, torch.zeros(kv_len, dtype=torch.int32, device=dev),
                torch.arange(kv_len, dtype=torch.int32, device=dev),
                paged_kv_cache, self._prefill_pages,
                torch.tensor([0, npg], dtype=torch.int32, device=dev),
                torch.tensor([(kv_len - 1) % self._page_size + 1],
                             dtype=torch.int32, device=dev),
                kv_layout=self._layout)
            out = self._attn.run(torch.cat([q_p, q_d]), paged_kv_cache,
                                 return_lse=return_lse, **kwargs)
            if return_lse:
                o, lse = out
                return ((o[:qo_len], o[qo_len:]), paged_kv_cache,
                        (lse[:qo_len], lse[qo_len:]))
            return (out[:qo_len], out[qo_len:]), paged_kv_cache

        p = single_prefill_with_kv_cache(
            q_p, k_p, v_p, causal=causal_p, return_lse=return_lse,
            backend=self._backend, **self._prefill_cfg)
        d = self._attn.run(q_d, paged_kv_cache, return_lse=return_lse,
                           **kwargs)
        if return_lse:
            (po, plse), (do, dlse) = p, d
            return (po, do), (plse, dlse)
        return p, d
