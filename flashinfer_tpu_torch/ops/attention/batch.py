"""Batch paged attention: the plan/run API.

Counterpart of ``flashinfer_tpu/ops/attention/batch.py``. ``plan()`` runs on
the host (NumPy): it turns a batch's indptrs into a padded, static-shape
work list (``scheduler.plan``) plus gather maps, and packs them into one
int32 ``DevicePlan`` blob with the reference's ``PlanMeta.blob_layout``, so
one blob drives both packages. ``run()`` gathers q into the GQA-packed
layout, launches the paged kernel (``kernels/paged.py``) and merges split-KV
partials (``state.gather_merge_states``).

This slice covers paged caches with the default softmax variant (sm_scale,
logits soft cap), causal and sliding-window masks, and an explicit
``kv_chunk_size``. Ragged KV, custom and multi-item masks, other variants,
attention sinks and pages smaller than 8 raise ``NotImplementedError``
(ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
)
from flashinfer_tpu_torch.ops.attention.state import gather_merge_states
from flashinfer_tpu_torch.scheduler.plan import (
    AttentionPlan,
    build_merge_src,
    kv_major_order,
    plan_attention,
)
from flashinfer_tpu_torch.utils import (
    TensorLayout,
    check_kv_layout,
    next_power_of_2,
    resolve_device,
    round_up,
)

__all__ = [
    "BatchAttention",
    "BatchPrefillWithPagedKVCacheWrapper",
    "BatchDecodeWithPagedKVCacheWrapper",
    "DevicePlan",
    "PlanMeta",
    "pack_queries",
    "run_device_plan",
]

_NOT_IN_SLICE = "not in this slice of the port (ROADMAP Queue 1, item 5)"


def _bucket(n: int, minimum: int = 1) -> int:
    return max(minimum, next_power_of_2(n))


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static half of a plan. The fields and ``blob_layout`` are the
    reference's, so the blob segments line up between the packages."""

    tile_q: int
    kv_chunk_size: int
    num_work_items: int
    page_size: int
    gqa_group: int
    bucket_rows: int
    nnz: int
    num_qo_heads: int
    num_kv_heads: int
    head_dim_qk: int
    head_dim_vo: int
    causal: bool
    sm_scale: float
    window_left: int
    ragged: bool
    kv_indices_len: int = 0
    max_splits: int = 1
    kv_major: bool = False
    has_mask: bool = False

    def blob_layout(self):
        """(name, length, shape) segments of the int32 blob."""
        T, tq = self.num_work_items, self.tile_q
        rows = self.bucket_rows
        return [
            ("plan", 12 * T, (12, T)),
            ("kv_indices", self.kv_indices_len, (self.kv_indices_len,)),
            ("row_src", rows, (rows,)),
            ("row_valid", rows, (rows,)),
            ("merge_out_row", T * tq, (T * tq,)),
            ("out_map", self.nnz * self.gqa_group,
             (self.nnz * self.gqa_group,)),
            ("merge_src", rows * self.max_splits, (rows, self.max_splits)),
        ]


@dataclasses.dataclass
class DevicePlan:
    """Dynamic half of a plan: every index array in ONE int32 tensor, so a
    step uploads its plan in one host-to-device copy. Segments are views."""

    blob: torch.Tensor  # [total] int32
    meta: PlanMeta

    @classmethod
    def build(cls, meta: PlanMeta, arrays: dict, device: torch.device,
              upload: bool = True) -> "DevicePlan":
        """Pack host arrays (keys: plan = the 12 plan rows, then the other
        segment names) into the blob and upload it. ``upload=False`` keeps
        the blob on the host, for a caller that moves it up together with
        its other inputs (the engine writes it into the static input buffer
        of its decode step's CUDA graph)."""
        parts = [np.asarray(a, np.int32).ravel() for a in arrays["plan"]]
        for name, _, _ in meta.blob_layout()[1:]:
            parts.append(np.asarray(arrays[name], np.int32).ravel())
        blob = torch.from_numpy(np.concatenate(parts))
        return cls(blob.to(device) if upload else blob, meta=meta)

    def segment(self, name: str) -> torch.Tensor:
        off = 0
        for seg_name, length, shape in self.meta.blob_layout():
            if seg_name == name:
                return self.blob[off:off + length].view(shape)
            off += length
        raise KeyError(name)


def pack_queries(dplan: DevicePlan, q: torch.Tensor) -> torch.Tensor:
    """q [nnz, hq, d] in the plan's GQA-packed layout [kvh, bucket_rows,
    d] (row = token * group + head in group, each request's rows
    tile_q-aligned); padding rows are 0."""
    m = dplan.meta
    nnz, hq, d = q.shape
    kvh = m.num_kv_heads
    q_r = (q.reshape(nnz, kvh, hq // kvh, d).permute(1, 0, 2, 3)
           .reshape(kvh, nnz * (hq // kvh), d))
    row_src = dplan.segment("row_src").long()
    row_valid = dplan.segment("row_valid") != 0
    return torch.where(row_valid[None, :, None], q_r[:, row_src], 0)


def run_device_plan(
    dplan: DevicePlan,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_layout: TensorLayout = TensorLayout.HND,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    kv_indices_offset: int = 0,
    logits_soft_cap: float = 0.0,
    return_lse: bool = False,
):
    """Execute a DevicePlan. q [nnz, hq, d]; k/v paged caches in
    ``kv_layout``. ``kv_indices_offset`` is added to every page id, so a
    cache that stacks all layers' pages ([L * pages, ...]) is passed whole.
    The cache's dtype says how it is read: ``torch.float8_e4m3fn`` as e4m3,
    int8 as the linear container."""
    m = dplan.meta
    if m.ragged or m.has_mask:
        raise NotImplementedError(f"ragged KV and custom masks are "
                                  f"{_NOT_IN_SLICE}")
    group = m.num_qo_heads // m.num_kv_heads
    nnz, hq, d = q.shape
    kvh = m.num_kv_heads

    partial_o, partial_lse = batch_paged_attention_run(
        pack_queries(dplan, q), k, v, dplan.segment("kv_indices"),
        dplan.segment("plan"), tile_q=m.tile_q, group=m.gqa_group,
        causal=m.causal, sm_scale=m.sm_scale, k_scale=k_scale,
        v_scale=v_scale, window_left=m.window_left,
        logits_soft_cap=logits_soft_cap, kv_layout=kv_layout,
        kv_indices_offset=kv_indices_offset,
        row_valid=dplan.segment("row_valid"),
    )
    dv = partial_o.shape[3]
    out_map = dplan.segment("out_map").long()
    merge_src = dplan.segment("merge_src")
    if m.max_splits == 1:
        # no split-KV: the merge is a permutation, so one gather goes
        # straight from the partials to the output rows
        comb = merge_src[:, 0].long()[out_map].clamp(min=0)
        w_idx, j_idx = comb // m.tile_q, comb % m.tile_q
        out = partial_o[w_idx, :, j_idx, :]  # [nnz * group, kvh, dv]
        lse = partial_lse[w_idx, :, j_idx] if return_lse else None
    else:
        merged_o, merged_lse = gather_merge_states(
            partial_o, partial_lse, merge_src, m.tile_q)
        out = merged_o[out_map]
        lse = merged_lse[out_map] if return_lse else None
    out = (out.reshape(nnz, group, kvh, dv).permute(0, 2, 1, 3)
           .reshape(nnz, hq, dv)[:, :, : m.head_dim_vo])
    if return_lse:
        lse = lse.reshape(nnz, group, kvh).permute(0, 2, 1).reshape(nnz, hq)
        return out, lse
    return out


@dataclasses.dataclass
class PlanState:
    plan: AttentionPlan
    device_plan: DevicePlan
    logits_soft_cap: float


class BatchAttention:
    """Variable-length paged attention with a plan/run split."""

    def __init__(
        self,
        kv_layout: str = "HND",
        *,
        tile_q: Optional[int] = None,
        device: str | torch.device = "cuda",
    ):
        self._layout = check_kv_layout(kv_layout)
        self._tile_q = tile_q
        self._device = resolve_device(device)
        self._state: Optional[PlanState] = None

    def plan(
        self,
        qo_indptr,
        kv_indptr,
        kv_indices,
        kv_last_page_len,
        num_qo_heads: int,
        num_kv_heads: int,
        head_dim_qk: int,
        page_size: int,
        *,
        kv_chunk_size: int,
        head_dim_vo: Optional[int] = None,
        causal: bool = False,
        sm_scale: Optional[float] = None,
        window_left: int = -1,
        logits_soft_cap: float = 0.0,
        kv_len_arr=None,
        work_capacity: Optional[int] = None,
        min_max_splits: int = 1,
        defer_upload: bool = False,
        custom_mask=None,
        packed_custom_mask=None,
    ):
        """Host-side plan. Index arguments are host arrays. ``kv_chunk_size``
        is required: the reference derives it from its TPU VMEM model when
        it is None, which has no meaning here. ``min_max_splits`` floors the
        merge's split dimension (a power of two), so plans of growing
        lengths can share one ``PlanMeta``; ``defer_upload`` leaves the
        plan's blob on the host."""
        if custom_mask is not None or packed_custom_mask is not None:
            raise NotImplementedError(f"custom masks are {_NOT_IN_SLICE}")
        if page_size < 8:
            raise NotImplementedError(
                f"pages smaller than 8 are {_NOT_IN_SLICE}")
        if kv_chunk_size is None:
            raise ValueError("kv_chunk_size must be given")
        qo_indptr = np.asarray(qo_indptr, np.int64)
        kv_indptr = np.asarray(kv_indptr, np.int64)
        kv_indices_np = np.asarray(kv_indices, np.int64)
        batch = len(qo_indptr) - 1
        head_dim_vo = head_dim_vo or head_dim_qk
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(head_dim_qk)
        if num_qo_heads % num_kv_heads:
            raise ValueError(f"{num_qo_heads} q heads are not a multiple of "
                             f"{num_kv_heads} kv heads")
        group = num_qo_heads // num_kv_heads

        if kv_len_arr is not None:
            kv_lens = np.asarray(kv_len_arr, np.int64)
        else:
            last = np.asarray(kv_last_page_len, np.int64)
            npages = kv_indptr[1:] - kv_indptr[:-1]
            kv_lens = np.where(npages > 0, (npages - 1) * page_size + last, 0)

        qo_lens = qo_indptr[1:] - qo_indptr[:-1]
        qo_token_total = int(qo_indptr[-1])

        # decode-like batches get a group-sized tile, prefill rows larger ones
        avg_packed = max(1, int((qo_lens * group).mean())) if batch else 1
        tile_q = self._tile_q or min(512, max(8, next_power_of_2(avg_packed)))
        tile_q = max(tile_q, next_power_of_2(group), 8)

        packed_lens = qo_lens * group
        padded_lens = np.maximum(round_up(packed_lens, tile_q), 0)
        padded_indptr = np.concatenate([[0], np.cumsum(padded_lens)])
        total_padded = int(padded_indptr[-1])
        bucket_rows = _bucket(max(total_padded, tile_q))

        plan = plan_attention(
            padded_indptr, kv_lens, qo_token_lens=qo_lens, gqa_group=group,
            kv_indptr=kv_indptr, page_size=page_size, tile_q=tile_q,
            kv_chunk_size=kv_chunk_size, work_capacity=work_capacity,
            causal=causal,
        )
        # prefill batches take the reference's kv-major item order; the
        # blob then matches the reference's bit for bit
        if np.any(packed_lens > tile_q):
            plan = kv_major_order(plan)

        # q gather maps: packed row -> (token, group head) and back
        rows = np.arange(bucket_rows)
        req_of_row = np.clip(
            np.searchsorted(padded_indptr, rows, side="right") - 1, 0,
            batch - 1)
        local = rows - padded_indptr[req_of_row]
        valid_row = (local < packed_lens[req_of_row]) & (rows < total_padded)
        token = qo_indptr[req_of_row] + local // group
        row_src = np.where(valid_row, token * group + local % group, 0)

        tg = np.arange(qo_token_total * group)
        tok = tg // group
        req_of_tok = np.clip(
            np.searchsorted(qo_indptr, tok, side="right") - 1, 0, batch - 1)
        out_map = (padded_indptr[req_of_tok]
                   + (tok - qo_indptr[req_of_tok]) * group + tg % group)

        kv_idx_host = np.zeros(_bucket(max(len(kv_indices_np), 1)), np.int32)
        kv_idx_host[: len(kv_indices_np)] = kv_indices_np

        merge_src = build_merge_src(plan.merge_out_row, bucket_rows,
                                    min_splits=min_max_splits)
        meta = PlanMeta(
            tile_q=plan.tile_q,
            kv_chunk_size=plan.kv_chunk_size,
            num_work_items=plan.num_work_items,
            page_size=page_size,
            gqa_group=plan.gqa_group,
            bucket_rows=bucket_rows,
            nnz=qo_token_total,
            num_qo_heads=num_qo_heads,
            num_kv_heads=num_kv_heads,
            head_dim_qk=head_dim_qk,
            head_dim_vo=head_dim_vo,
            causal=causal,
            sm_scale=sm_scale,
            window_left=window_left,
            ragged=False,
            kv_indices_len=int(kv_idx_host.shape[0]),
            max_splits=int(merge_src.shape[1]),
            kv_major=plan.kv_major,
        )
        device_plan = DevicePlan.build(
            meta,
            dict(plan=plan.prefetch_arrays(), kv_indices=kv_idx_host,
                 row_src=row_src, row_valid=valid_row,
                 merge_out_row=plan.merge_out_row, out_map=out_map,
                 merge_src=merge_src),
            self._device, upload=not defer_upload,
        )
        self._state = PlanState(plan, device_plan, float(logits_soft_cap))
        return self

    @property
    def device_plan(self) -> Optional[DevicePlan]:
        """The plan as run_device_plan takes it."""
        return self._state.device_plan if self._state else None

    def run(
        self,
        q: torch.Tensor,
        kv_cache,
        *,
        k_scale: float = 1.0,
        v_scale: float = 1.0,
        return_lse: bool = False,
    ):
        """Execute the planned batch. q [nnz, hq, d]; kv_cache a (k, v) pair
        of paged caches in the wrapper's layout."""
        st = self._state
        if st is None:
            raise RuntimeError("call plan() before run()")
        if q.shape[0] != st.device_plan.meta.nnz:
            raise ValueError(f"q rows {q.shape[0]} != planned "
                             f"{st.device_plan.meta.nnz}")
        k, v = kv_cache
        return run_device_plan(
            st.device_plan, q, k, v, kv_layout=self._layout,
            k_scale=k_scale, v_scale=v_scale,
            logits_soft_cap=st.logits_soft_cap, return_lse=return_lse,
        )


class BatchPrefillWithPagedKVCacheWrapper(BatchAttention):
    """Prefill (and append) over a paged cache; qo_indptr gives each
    request's query tokens."""


class BatchDecodeWithPagedKVCacheWrapper(BatchAttention):
    """One query token per request. The GQA group rides the packed-row
    dimension, as in the reference's tensor-core decode path."""

    def plan(self, indptr, indices, last_page_len, num_qo_heads,
             num_kv_heads, head_dim, page_size, **kwargs):
        batch = len(np.asarray(indptr)) - 1
        kwargs.setdefault("causal", False)
        return super().plan(np.arange(batch + 1), indptr, indices,
                            last_page_len, num_qo_heads, num_kv_heads,
                            head_dim, page_size, **kwargs)
