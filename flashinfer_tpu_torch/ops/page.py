"""Paged KV-cache operations (counterpart of flashinfer_tpu/ops/page.py).

Page table: ``kv_indptr`` [batch+1] CSR offsets into ``kv_indices`` (page
ids per request, in order), ``kv_last_page_len`` [batch]. Caches: a (k, v)
pair or one tensor with a leading 2 on dim 1; layouts NHD [pages,
page_size, heads, dim] or HND [pages, heads, page_size, dim]. MLA caches
are headless: ckv [pages, page_size, d_ckv], kpe [pages, page_size, d_kpe].

The JAX package appends functionally (``cache.at[...].set``, made in-place
by buffer donation); here the appends write the caches in place and return
them. 8-bit caches are written through an int8 view of their bytes.
``unpack_paged_kv_cache`` and ``block_sparse_indices_to_vector_sparse_offsets``
follow JAX's (:44, :196).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from flashinfer_tpu_torch.utils import TensorLayout, check_kv_layout

__all__ = [
    "get_seq_lens",
    "get_batch_indices_positions",
    "append_paged_kv_cache",
    "append_paged_mla_kv_cache",
    "unpack_paged_kv_cache",
    "block_sparse_indices_to_vector_sparse_offsets",
]

KVCache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _split_pair(paged_kv_cache: KVCache
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if isinstance(paged_kv_cache, (tuple, list)):
        return paged_kv_cache[0], paged_kv_cache[1]
    if paged_kv_cache.shape[1] != 2:
        raise ValueError("single-tensor paged cache must be [pages, 2, "
                         f"...]; got {tuple(paged_kv_cache.shape)}")
    return paged_kv_cache[:, 0], paged_kv_cache[:, 1]


def unpack_paged_kv_cache(paged_kv_cache: KVCache,
                          kv_layout: str | TensorLayout = "NHD"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (k, v) pair or a [pages, 2, ...] tensor in ``kv_layout`` as (k, v)
    views, each NHD [pages, page_size, num_kv_heads, head_dim]."""
    layout = check_kv_layout(kv_layout)
    k, v = _split_pair(paged_kv_cache)
    if layout == TensorLayout.HND:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return k, v


def get_seq_lens(kv_indptr: torch.Tensor, kv_last_page_len: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """Per-request KV length (flashinfer_tpu/ops/page.py:68)."""
    num_pages = kv_indptr[1:] - kv_indptr[:-1]
    return torch.where(num_pages > 0,
                       (num_pages - 1) * page_size + kv_last_page_len,
                       0).to(torch.int32)


def get_batch_indices_positions(
    append_indptr: torch.Tensor, seq_lens: torch.Tensor, nnz: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For ``nnz`` tokens packed by ``append_indptr``, each token's request
    and absolute position; the appended tokens are the last of their
    sequence (flashinfer_tpu/ops/page.py:80)."""
    token = torch.arange(nnz, dtype=torch.int64, device=append_indptr.device)
    indptr = append_indptr.long()
    batch_indices = torch.searchsorted(indptr, token, right=True) - 1
    append_start = indptr[batch_indices]
    append_len = indptr[batch_indices + 1] - append_start
    positions = (seq_lens.long()[batch_indices] - append_len
                 + (token - append_start))
    return batch_indices.to(torch.int32), positions.to(torch.int32)


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """Index-put is not implemented for float8 tensors: write their bytes."""
    return t.view(torch.int8) if t.dtype == torch.float8_e4m3fn else t


def _slots(batch_indices, positions, kv_indices, kv_indptr, page_size,
           valid: Optional[torch.Tensor]):
    """(page id, entry) of every appended token, without the padding rows
    (``valid`` False): the JAX package routes those out of range and drops
    them in the scatter."""
    positions = positions.long()
    page_ids = kv_indices.long()[kv_indptr.long()[batch_indices.long()]
                                 + positions // page_size]
    entry_ids = positions % page_size
    if valid is None:
        return page_ids, entry_ids, None
    return page_ids[valid], entry_ids[valid], valid


def _scatter(cache: torch.Tensor, tokens: torch.Tensor, page_ids, entry_ids,
             keep, hnd: bool = False) -> None:
    if keep is not None:
        tokens = tokens[keep]
    tokens = _byte_view(tokens.to(cache.dtype))
    cache = _byte_view(cache)
    if hnd:
        cache[page_ids, :, entry_ids] = tokens
    else:
        cache[page_ids, entry_ids] = tokens


def append_paged_kv_cache(
    append_key: torch.Tensor,
    append_value: torch.Tensor,
    batch_indices: torch.Tensor,
    positions: torch.Tensor,
    paged_kv_cache: KVCache,
    kv_indices: torch.Tensor,
    kv_indptr: torch.Tensor,
    kv_last_page_len: torch.Tensor,
    kv_layout: str | TensorLayout = "NHD",
    *,
    valid: Optional[torch.Tensor] = None,
) -> KVCache:
    """Write new K/V tokens [nnz, num_kv_heads, head_dim] at (request,
    position) into the paged cache, in place (flashinfer_tpu/ops/page.py:
    114). ``valid`` [nnz] bool marks rows to write; False rows are
    dropped. Returns the cache."""
    layout = check_kv_layout(kv_layout)
    k, v = _split_pair(paged_kv_cache)
    hnd = layout == TensorLayout.HND
    page_size = k.shape[2] if hnd else k.shape[1]
    page_ids, entry_ids, keep = _slots(batch_indices, positions, kv_indices,
                                       kv_indptr, page_size, valid)
    _scatter(k, append_key, page_ids, entry_ids, keep, hnd)
    _scatter(v, append_value, page_ids, entry_ids, keep, hnd)
    return paged_kv_cache


def append_paged_mla_kv_cache(
    append_ckv: torch.Tensor,
    append_kpe: torch.Tensor,
    batch_indices: torch.Tensor,
    positions: torch.Tensor,
    ckv_cache: torch.Tensor,
    kpe_cache: torch.Tensor,
    kv_indices: torch.Tensor,
    kv_indptr: torch.Tensor,
    kv_last_page_len: torch.Tensor,
    *,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA variant (flashinfer_tpu/ops/page.py:163): append_ckv [nnz, d_ckv]
    and append_kpe [nnz, d_kpe] into the headless caches, in place. A
    pre-padded kpe cache (wider than d_kpe) takes the tokens in its first
    d_kpe columns. Returns (ckv_cache, kpe_cache)."""
    page_ids, entry_ids, keep = _slots(batch_indices, positions, kv_indices,
                                       kv_indptr, ckv_cache.shape[1], valid)
    _scatter(ckv_cache, append_ckv, page_ids, entry_ids, keep)
    _scatter(kpe_cache[..., : append_kpe.shape[-1]], append_kpe, page_ids,
             entry_ids, keep)
    return ckv_cache, kpe_cache


def block_sparse_indices_to_vector_sparse_offsets(
    block_sparse_indices: torch.Tensor,
    block_sparse_indptr: torch.Tensor,
    vector_sparse_offsets: torch.Tensor,
    vector_sparse_indptr: torch.Tensor,
    kv_lens: torch.Tensor,
    stride_block: int,
    stride_n: int,
    block_size: int,
) -> torch.Tensor:
    """Per-token offsets of a block-sparse KV layout: token j of row r
    (entries vector_sparse_indptr[r]:[r + 1] of the output) lies in block
    block_sparse_indices[block_sparse_indptr[r] + j // block_size], at
    block * stride_block + (j % block_size) * stride_n; entries past the
    row's kv_lens are 0. Returns a new tensor of
    ``vector_sparse_offsets``' shape and dtype (the JAX package's
    functional update), or, for blocks of one token with stride_block ==
    stride_n, ``block_sparse_indices * stride_n``, as JAX does."""
    if block_size == 1 and stride_block == stride_n:
        return block_sparse_indices * stride_n
    num_out = vector_sparse_offsets.shape[0]
    vec_indptr = vector_sparse_indptr.long()
    blk_indptr = block_sparse_indptr.long()
    token = torch.arange(num_out, device=vec_indptr.device)
    row = (torch.searchsorted(vec_indptr, token, right=True) - 1).clamp(
        0, blk_indptr.shape[0] - 2)
    elem = token - vec_indptr[row]
    in_bounds = elem < kv_lens.long()[row]
    src = block_sparse_indices.long()[
        (blk_indptr[row] + elem // block_size).clamp(
            0, block_sparse_indices.shape[0] - 1)]
    offsets = src * stride_block + (elem % block_size) * stride_n
    return torch.where(in_bounds, offsets, 0).to(vector_sparse_offsets.dtype)
