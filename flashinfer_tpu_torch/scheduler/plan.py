"""Host-side attention work planner (NumPy) — the plan stage of plan/run.

A copy of the NumPy planner in ``flashinfer_tpu/scheduler/plan.py``
(``_plan_attention_numpy``, which that module calls the spec), plus
``build_merge_src`` and ``kv_major_order``. It produces the same arrays bit
for bit, so one plan can drive both packages. ``plan_attention`` runs the
C++ twin of the planner (``scheduler/native.py``) where the host runtime
builds, as the JAX package's does (``FLASHINFER_TPU_PLANNER``); the NumPy
planner stays the spec the two are held to.

Work item = (request, qo_tile, kv_chunk). The arrays are padded to a
power-of-two capacity, so the device side sees a static-shape work list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from flashinfer_tpu_torch.utils import next_power_of_2, round_up

__all__ = [
    "AttentionPlan",
    "plan_attention",
    "build_merge_src",
    "kv_major_order",
]

_MIN_WORK_CAPACITY = 8


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Static-shape work descriptors consumed by the paged attention kernel.

    Arrays are NumPy int32 of shape [T]; padding items have
    ``request_indices == -1``.
    """

    tile_q: int  # query rows per work item (packed layout)
    kv_chunk_size: int  # max kv tokens per work item (page-aligned)
    num_work_items: int  # padded capacity T
    total_rows: int  # padded packed qo rows (output rows)
    batch_size: int
    page_size: int

    request_indices: np.ndarray
    qo_tile_indices: np.ndarray
    kv_tile_indices: np.ndarray
    qo_start_row: np.ndarray  # first packed output row of this tile
    qo_tile_len: np.ndarray  # valid rows in this tile (<= tile_q)
    kv_start: np.ndarray  # kv token range [start, end) within request
    kv_end: np.ndarray
    kv_page_start: np.ndarray  # offset into kv_indices of first page of chunk
    num_kv_splits: np.ndarray  # how many chunks the (req, qo_tile) group has
    # absolute token position of packed row p (within the request) is
    # q_pos_base + p // gqa_group
    q_pos_base: np.ndarray
    gqa_group: int

    # partial row (w * tile_q + j) -> destination output row, or -1
    merge_out_row: np.ndarray  # [T * tile_q]

    num_valid_items: int

    # kv-major ordering bookkeeping (the reference kernel's DMA dedup; the
    # port's kernel ignores these two rows but keeps them in the blob)
    dma_new: Optional[np.ndarray] = None  # [T]
    dma_slot: Optional[np.ndarray] = None  # [T]
    kv_major: bool = False

    def prefetch_arrays(self) -> Tuple[np.ndarray, ...]:
        """The 12 plan rows in the fixed order of the plan blob."""
        T = self.num_work_items
        dma_new = (
            self.dma_new if self.dma_new is not None else np.ones(T, np.int32)
        )
        dma_slot = (
            self.dma_slot
            if self.dma_slot is not None
            else (np.arange(T) % 2).astype(np.int32)
        )
        return (
            self.request_indices,
            self.qo_tile_indices,
            self.kv_tile_indices,
            self.qo_start_row,
            self.qo_tile_len,
            self.kv_start,
            self.kv_end,
            self.kv_page_start,
            self.num_kv_splits,
            self.q_pos_base,
            dma_new,
            dma_slot,
        )


def _bucket(n: int, minimum: int = _MIN_WORK_CAPACITY) -> int:
    return max(minimum, next_power_of_2(n))


def _cdiv_np(a, b):
    return -(-a // b)


def plan_attention(
    qo_indptr: np.ndarray,
    kv_lens: np.ndarray,
    *,
    backend: Optional[str] = None,
    **kwargs,
) -> AttentionPlan:
    """Plan a variable-length attention batch (arguments: see
    ``_plan_attention_numpy``).

    backend: "native" (the C++ planner), "numpy", or None to follow
    ``FLASHINFER_TPU_PLANNER`` ("auto", the default: native where the host
    runtime builds). The two give equal plans, field by field.
    """
    if backend is None:
        from flashinfer_tpu_torch.jit.env import planner_backend

        backend = planner_backend()
    if backend not in ("native", "numpy", "auto"):
        raise ValueError(f"unknown planner backend {backend!r}")
    if backend in ("native", "auto"):
        from flashinfer_tpu_torch.scheduler.native import (
            native_plan_attention,
            native_plan_available,
        )

        if native_plan_available():
            return native_plan_attention(qo_indptr, kv_lens, **kwargs)
        if backend == "native":
            raise RuntimeError("the native planner was asked for, but the "
                               "host runtime did not build")
    return _plan_attention_numpy(qo_indptr, kv_lens, **kwargs)


def plan_prefill(*args, **kwargs) -> AttentionPlan:
    """``plan_attention`` with the prefill default ``tile_q`` 128
    (flashinfer_tpu/scheduler/plan.py:443)."""
    kwargs.setdefault("tile_q", 128)
    return plan_attention(*args, **kwargs)


def plan_decode(
    kv_lens: np.ndarray,
    *,
    kv_indptr: Optional[np.ndarray] = None,
    page_size: int = 1,
    gqa_group: int = 1,
    tile_q: Optional[int] = None,
    **kwargs,
) -> AttentionPlan:
    """Decode plan: one query token a request, its ``gqa_group`` packed
    rows padded to one tile of ``max(8, next_pow2(gqa_group))`` rows
    (flashinfer_tpu/scheduler/plan.py:449)."""
    batch = len(kv_lens)
    if tile_q is None:
        tile_q = max(8, next_power_of_2(gqa_group))
    return plan_attention(
        np.arange(batch + 1) * tile_q, kv_lens,
        qo_token_lens=np.ones(batch, np.int64), gqa_group=gqa_group,
        kv_indptr=kv_indptr, page_size=page_size, tile_q=tile_q, **kwargs)


def _plan_attention_numpy(
    qo_indptr: np.ndarray,
    kv_lens: np.ndarray,
    *,
    qo_token_lens: Optional[np.ndarray] = None,
    gqa_group: int = 1,
    kv_indptr: Optional[np.ndarray] = None,
    page_size: int = 1,
    tile_q: int = 128,
    kv_chunk_size: Optional[int] = None,
    max_kv_chunk_size: int = 4096,
    min_kv_chunk_size: int = 256,
    target_num_items: Optional[int] = None,
    work_capacity: Optional[int] = None,
    causal: bool = False,
) -> AttentionPlan:
    """Plan a variable-length attention batch.

    Args:
      qo_indptr: [batch+1] packed query-ROW offsets (a row is a (token,
        group-head) pair), already padded to tile_q alignment.
      kv_lens: [batch] valid kv tokens per request.
      qo_token_lens: [batch] true token counts (defaults to row_count //
        gqa_group); padded rows must not shift causal positions.
      gqa_group: rows per token (query heads per kv head).
      kv_indptr: [batch+1] page-table offsets; identity if None.
      kv_chunk_size: fixed chunk size; if None, the smallest power of two in
        [min, max] giving at least ``target_num_items`` items.
    """
    qo_indptr = np.asarray(qo_indptr, np.int64)
    kv_lens = np.asarray(kv_lens, np.int64)
    batch_size = len(kv_lens)
    if qo_indptr.shape != (batch_size + 1,):
        raise ValueError(f"qo_indptr has shape {qo_indptr.shape}, want "
                         f"({batch_size + 1},)")
    if batch_size == 0:
        capacity = work_capacity or _MIN_WORK_CAPACITY
        if kv_chunk_size is None:
            kv_chunk_size = max_kv_chunk_size
            while kv_chunk_size // 2 >= min_kv_chunk_size:
                kv_chunk_size //= 2
        chunk = round_up(max(kv_chunk_size, page_size), page_size)
        zeros = np.zeros(capacity, np.int32)
        return AttentionPlan(
            tile_q=tile_q, kv_chunk_size=int(chunk), num_work_items=capacity,
            total_rows=0, batch_size=0, page_size=page_size,
            request_indices=np.full(capacity, -1, np.int32),
            qo_tile_indices=zeros, kv_tile_indices=zeros,
            qo_start_row=zeros, qo_tile_len=zeros, kv_start=zeros,
            kv_end=zeros, kv_page_start=zeros,
            num_kv_splits=np.ones(capacity, np.int32),
            q_pos_base=zeros, gqa_group=gqa_group,
            merge_out_row=np.full(capacity * tile_q, -1, np.int32),
            num_valid_items=0,
        )
    qo_lens = qo_indptr[1:] - qo_indptr[:-1]
    if qo_token_lens is None:
        qo_token_lens = qo_lens // gqa_group
    qo_token_lens = np.asarray(qo_token_lens, np.int64)
    num_qo_tiles = np.maximum(
        _cdiv_np(qo_lens, tile_q), (qo_lens > 0).astype(np.int64))

    if kv_chunk_size is None:
        if target_num_items is None:
            target_num_items = max(8, int(num_qo_tiles.sum()))
        kv_chunk_size = max_kv_chunk_size
        while (
            kv_chunk_size // 2 >= min_kv_chunk_size
            and int(
                (num_qo_tiles
                 * _cdiv_np(np.maximum(kv_lens, 1), kv_chunk_size)).sum()
            )
            < target_num_items
        ):
            kv_chunk_size //= 2
        # never derive a chunk wider than the longest request
        kv_chunk_size = min(
            kv_chunk_size,
            int(next_power_of_2(int(np.maximum(kv_lens, 1).max()))),
        )
    kv_chunk_size = round_up(max(kv_chunk_size, page_size), page_size)

    num_kv_chunks = _cdiv_np(np.maximum(kv_lens, 1), kv_chunk_size)

    # expand (request, qo_tile, kv_chunk) triples, vectorized
    items_per_req = num_qo_tiles * num_kv_chunks
    total_items = int(items_per_req.sum())
    req_of_item = np.repeat(np.arange(batch_size), items_per_req)
    item_ofs = np.arange(total_items) - np.repeat(
        np.concatenate([[0], np.cumsum(items_per_req)[:-1]]), items_per_req
    )
    nkc = num_kv_chunks[req_of_item]
    qo_tile_idx = item_ofs // nkc
    kv_tile_idx = item_ofs % nkc

    kv_start = kv_tile_idx * kv_chunk_size
    kv_end = np.minimum(kv_start + kv_chunk_size, kv_lens[req_of_item])

    # causal pruning: kv above the tile's last row diagonal is invisible to
    # every row of the tile, so such chunks are dropped and straddling chunks
    # are clipped
    q_pos_base = kv_lens[req_of_item] - qo_token_lens[req_of_item]
    if causal:
        last_token = (qo_tile_idx * tile_q + tile_q - 1) // gqa_group
        kv_upper = q_pos_base + last_token + 1  # exclusive
        keep = kv_start < np.minimum(kv_upper, kv_lens[req_of_item])
        kv_end = np.minimum(kv_end, kv_upper)
    else:
        keep = np.ones(total_items, dtype=bool)
    keep &= kv_end > kv_start

    req_of_item = req_of_item[keep]
    qo_tile_idx = qo_tile_idx[keep]
    kv_tile_idx = kv_tile_idx[keep]
    kv_start = kv_start[keep]
    kv_end = kv_end[keep]
    q_pos_base = q_pos_base[keep]
    num_valid = len(req_of_item)

    # splits per (request, qo_tile) group after pruning
    group_key = req_of_item * (num_qo_tiles.max() + 1) + qo_tile_idx
    _, first_idx, counts = np.unique(
        group_key, return_index=True, return_counts=True)
    splits = np.empty(num_valid, np.int64)
    for f, c in zip(first_idx, counts):
        splits[f : f + c] = c  # groups are contiguous (row-major expansion)

    qo_start_row = qo_indptr[req_of_item] + qo_tile_idx * tile_q
    qo_tile_len = np.minimum(
        tile_q, qo_lens[req_of_item] - qo_tile_idx * tile_q)

    if kv_indptr is not None:
        kv_indptr = np.asarray(kv_indptr, np.int64)
        kv_page_start = kv_indptr[req_of_item] + kv_start // page_size
    else:
        kv_page_start = kv_start // page_size

    capacity = work_capacity or _bucket(num_valid)
    if num_valid > capacity:
        raise ValueError(
            f"plan needs {num_valid} work items > capacity {capacity}; raise "
            "work_capacity"
        )

    def pad(a, fill):
        out = np.full(capacity, fill, np.int32)
        out[:num_valid] = a
        return out

    total_rows = int(qo_indptr[-1])

    merge_out_row = np.full(capacity * tile_q, -1, np.int32)
    w = np.arange(num_valid)
    rows = (qo_start_row[:, None] + np.arange(tile_q)[None, :]).astype(np.int64)
    valid_rows = np.arange(tile_q)[None, :] < qo_tile_len[:, None]
    flat = (w[:, None] * tile_q + np.arange(tile_q)[None, :])[valid_rows]
    merge_out_row[flat] = rows[valid_rows]

    return AttentionPlan(
        tile_q=tile_q,
        kv_chunk_size=int(kv_chunk_size),
        num_work_items=capacity,
        total_rows=total_rows,
        batch_size=batch_size,
        page_size=page_size,
        request_indices=pad(req_of_item, -1),
        qo_tile_indices=pad(qo_tile_idx, 0),
        kv_tile_indices=pad(kv_tile_idx, 0),
        qo_start_row=pad(qo_start_row, 0),
        qo_tile_len=pad(qo_tile_len, 0),
        kv_start=pad(kv_start, 0),
        kv_end=pad(kv_end, 0),
        kv_page_start=pad(kv_page_start, 0),
        num_kv_splits=pad(splits, 1),
        q_pos_base=pad(q_pos_base, 0),
        gqa_group=gqa_group,
        merge_out_row=merge_out_row,
        num_valid_items=num_valid,
    )


def build_merge_src(
    merge_out_row: np.ndarray, bucket_rows: int, min_splits: int = 1
) -> np.ndarray:
    """Invert the partial->row map into [bucket_rows, max_splits] gather
    sources (flat partial-row indices, -1 padded; max_splits is a power of
    two). Consumed by ``ops.attention.state.gather_merge_states``."""
    p_idx = np.nonzero(merge_out_row >= 0)[0]
    r = merge_out_row[p_idx]
    order = np.argsort(r, kind="stable")
    p_idx, r = p_idx[order], r[order]
    counts = np.bincount(r, minlength=bucket_rows) if len(r) else \
        np.zeros(bucket_rows, np.int64)
    max_splits = max(int(counts.max()) if counts.size else 1, 1, min_splits)
    max_splits = int(next_power_of_2(max_splits))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(p_idx)) - starts[r]
    merge_src = np.full((bucket_rows, max_splits), -1, np.int32)
    merge_src[r, slot] = p_idx
    return merge_src


def kv_major_order(plan: AttentionPlan) -> AttentionPlan:
    """Reorder work items (request, KV-tile)-major, qo tiles descending
    within a group, and attach the dedup rows (``dma_new``, ``dma_slot``).

    The port's kernel runs items in parallel and ignores the dedup rows;
    the order is kept so the plan blob is the reference's, bit for bit.
    """
    T = plan.num_work_items
    n = plan.num_valid_items
    req = plan.request_indices[:n]
    kvt = plan.kv_tile_indices[:n]
    qot = plan.qo_tile_indices[:n]
    order = np.lexsort((-qot, kvt, req))

    def ro(a, fill):
        out = np.full(T, fill, np.int32)
        out[:n] = a[:n][order]
        return out

    new = dataclasses.replace(
        plan,
        request_indices=ro(plan.request_indices, -1),
        qo_tile_indices=ro(plan.qo_tile_indices, 0),
        kv_tile_indices=ro(plan.kv_tile_indices, 0),
        qo_start_row=ro(plan.qo_start_row, 0),
        qo_tile_len=ro(plan.qo_tile_len, 0),
        kv_start=ro(plan.kv_start, 0),
        kv_end=ro(plan.kv_end, 0),
        kv_page_start=ro(plan.kv_page_start, 0),
        num_kv_splits=ro(plan.num_kv_splits, 1),
        q_pos_base=ro(plan.q_pos_base, 0),
    )
    merge_out_row = np.full(T * plan.tile_q, -1, np.int32)
    for w in range(n):
        tl = new.qo_tile_len[w]
        merge_out_row[w * plan.tile_q : w * plan.tile_q + tl] = (
            new.qo_start_row[w] + np.arange(tl)
        )
    dma_new = np.ones(T, np.int32)
    if n > 1:
        same = (new.request_indices[1:n] == new.request_indices[: n - 1]) & (
            new.kv_tile_indices[1:n] == new.kv_tile_indices[: n - 1]
        )
        dma_new[1:n] = (~same).astype(np.int32)
    seg = np.cumsum(dma_new) - 1
    dma_slot = (seg % 2).astype(np.int32)
    return dataclasses.replace(
        new, merge_out_row=merge_out_row, dma_new=dma_new, dma_slot=dma_slot,
        kv_major=True,
    )
