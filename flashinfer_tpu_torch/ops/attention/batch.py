"""Batch paged attention: the plan/run API.

Counterpart of ``flashinfer_tpu/ops/attention/batch.py``. ``plan()`` runs on
the host (NumPy): it turns a batch's indptrs into a padded, static-shape
work list (``scheduler.plan``) plus gather maps, and packs them into one
int32 ``DevicePlan`` blob with the reference's ``PlanMeta.blob_layout``, so
one blob drives both packages. ``run()`` gathers q into the GQA-packed
layout, launches the paged kernel (``kernels/paged.py``), and merges its
split-KV partials into the caller's layout (``kernels/paged_merge.py``: one
launch on the card, JAX's ``gather_merge_states`` composition on the CPU).

What a plan carries, as JAX's does:

- causal and sliding-window masks; custom masks (``custom_mask``,
  ``packed_custom_mask``) and multi-item scoring, legalised on the host
  into JAX's work mask (uint8 [T, tile_q, kv_chunk_size]), held beside the
  blob as ``DevicePlan.work_mask``, with its tile map (``paged_tile_map``
  on the host: which 64-key tiles of each item's 64-row blocks the mask
  keeps nothing of, whole, or in part) as ``DevicePlan.tile_map``, which
  the kernel reads to skip the first and run the second without the mask;
- variants: the built-in ones (the soft cap, ALiBi from
  ``variant_params["alibi_slopes"]``) run in the kernel; a variant with
  hooks of the caller's own runs in the plain version only;
- pages under 8 tokens take JAX's repack: the plan is built on a synthetic
  cache of 128-token pages, and the plan carries the gather map
  (``DevicePlan.repack``), so ``run_device_plan`` fills that cache from the
  caller's with one gather whoever runs the plan. Pages of 8 or more are
  planned natively, as JAX plans them (the kernel reads a page of any size
  in place: by TMA at a multiple of 8 tokens, else by its cp.async
  gather);
- ``kv_chunk_size=None``: decode-like plans balance as JAX's planner does;
  prefill plans take ``prefill_kv_chunk``, an H100 rule in place of JAX's
  VMEM model;
- the rows a work item (``tile_q``) of a prefill plan the caller did not
  pin: the autotuner's persisted winner for the batch's shape where it has
  one, else the derived size; inside ``autotune()`` the first ``run()``
  times each of ``PREFILL_TILE_QS`` (the tensor-core route's tiles) and
  persists the fastest (the counterpart of JAX's ``_select_tiles``).

``BatchPrefillWithRaggedKVCacheWrapper`` (contiguous KV planned as pages
of one token, so repacked into 128-token pages as JAX's are) and
``BatchAttentionWithAttentionSinkWrapper`` (``merge_state`` with the
sink's state) are built as JAX builds them.

Backends: "auto" launches the kernel on a CUDA tensor and takes its plain
version on a CPU tensor; "reference" runs the per-request oracle
``attention_reference``. "pallas" names the TPU kernel and is refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
    paged_tile_map,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged_merge import (
    paged_merge,
)
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.state import merge_state
from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    make_default_variant,
)
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
    "BatchAttentionWithAttentionSinkWrapper",
    "BatchDecodeWithPagedKVCacheWrapper",
    "BatchPrefillWithPagedKVCacheWrapper",
    "BatchPrefillWithRaggedKVCacheWrapper",
    "DevicePlan",
    "PartialsWorkspace",
    "PlanMeta",
    "kernel_caches",
    "pack_queries",
    "prefill_kv_chunk",
    "run_device_plan",
]

_SYN_PAGE = 128  # tokens a page of the repacked cache (JAX's)
_H100_SMS = 132  # the SM count a plan for the CPU assumes
_KERNEL_ROWS = 128  # packed rows a CTA of the prefill kernel


def _bucket(n: int, minimum: int = 1) -> int:
    return max(minimum, next_power_of_2(n))


def _host(x, dtype=None) -> np.ndarray:
    """A host array of ``x`` (numpy, a list, or a tensor on any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


# --- masks: copies of the JAX package's plan-time helpers ------------------

def _unpack_request_masks(packed, dense, mask_indptr, qo_lens, kv_lens):
    """Per-request [qo_len, kv_len] bool masks from the reference's
    custom_mask (dense concat) or packed_custom_mask (packbits, 'big'
    bitorder). mask_indptr holds per-request BIT offsets; derived from lens
    if None."""
    if packed is not None:
        bits = np.unpackbits(_host(packed, np.uint8))
    else:
        bits = _host(dense).astype(np.uint8).ravel()
    sizes = np.asarray(qo_lens, np.int64) * np.asarray(kv_lens, np.int64)
    if mask_indptr is None:
        mask_indptr = np.concatenate([[0], np.cumsum(sizes)])
    mask_indptr = _host(mask_indptr, np.int64)
    masks = []
    for r in range(len(sizes)):
        qo, kv = int(qo_lens[r]), int(kv_lens[r])
        s = int(mask_indptr[r])
        masks.append(bits[s: s + qo * kv].reshape(qo, kv).astype(bool))
    return masks


def _multi_item_masks(qo_lens, kv_lens, prefix_len, tpos, L):
    """Multi-item scoring masks: a query token in the item region attends
    to the shared prefix plus its own item only; prefix queries see
    everything (under the causal bound). tpos[p - prefix] is the token's
    position within its item (0 = delimiter)."""
    masks = []
    tpos = np.asarray(tpos, np.int64).ravel()
    for r in range(len(qo_lens)):
        qo, kv = int(qo_lens[r]), int(kv_lens[r])
        pre = int(prefix_len[r])
        t = tpos[r * L: (r + 1) * L]
        p = kv - qo + np.arange(qo)  # query tokens sit at the sequence tail
        rel = np.clip(p - pre, 0, max(len(t) - 1, 0))
        item_start = p - (t[rel] if len(t) else 0)
        kvi = np.arange(kv)[None, :]
        keep = np.where((p < pre)[:, None], True,
                        (kvi < pre) | (kvi > item_start[:, None]))
        masks.append(keep)
    return masks


def _build_work_mask(plan, req_masks, group):
    """Legalise per-request masks into the kernel's work-item tiling:
    uint8 [T, tile_q, kv_chunk_size], rows = GQA-packed q rows, cols = the
    item's chunk of keys. Out-of-range rows/cols are clipped; the kernel's
    own bounds already exclude them."""
    T, tq, chunk = plan.num_work_items, plan.tile_q, plan.kv_chunk_size
    wm = np.ones((T, tq, chunk), np.uint8)
    for w in range(T):
        r = int(plan.request_indices[w])
        if r < 0 or req_masks[r] is None:
            continue
        m = req_masks[r]
        toks = (plan.qo_tile_indices[w] * tq + np.arange(tq)) // group
        toks = np.clip(toks, 0, m.shape[0] - 1)
        cols = np.clip(plan.kv_start[w] + np.arange(chunk), 0, m.shape[1] - 1)
        wm[w] = m[np.ix_(toks, cols)]
    return wm


def _count_items(qo_rows, qo_lens, kv_lens, group: int, tile_q: int,
                 chunk: int, causal: bool) -> int:
    """``plan_attention``'s count of real work items at ``chunk``, in closed
    form: a request's qo tiles times its chunks, each tile's keys cut at
    its last row's causal bound."""
    tiles = np.maximum(-(-qo_rows // tile_q), (qo_rows > 0).astype(np.int64))
    r = np.repeat(np.arange(len(tiles)), tiles)
    t = np.arange(len(r)) - np.repeat(np.cumsum(tiles) - tiles, tiles)
    keys = kv_lens[r]
    if causal:
        keys = np.minimum(keys, kv_lens[r] - qo_lens[r]
                          + (t * tile_q + tile_q - 1) // group + 1)
    return int((-(-np.maximum(keys, 0) // chunk)).sum())


def prefill_kv_chunk(qo_rows, qo_lens, kv_lens, *, group: int, tile_q: int,
                     page_size: int, num_kv_heads: int, causal: bool,
                     num_sms: int) -> int:
    """The KV chunk of a prefill plan asked for with ``kv_chunk_size=None``.

    JAX sizes it from its TPU VMEM model (``tile_candidates``). The paged
    kernel streams any chunk through its ring of key tiles, so shared
    memory sets no upper bound here; only filling the SMs does. The rule:
    the largest page-aligned power of two, at most the longest request's
    KV, for which the plan gives at least one CTA an SM, a CTA being an
    (item, kv head, 128-row block). It halves no further than 128 keys (the
    kernel's key tile) or the page. Items are counted as the plan would
    make them (causal pruning included) from the requests' packed rows,
    query tokens and keys."""
    kv_lens = np.asarray(kv_lens, np.int64)
    floor = max(page_size, _KERNEL_ROWS)
    chunk = max(1 << (max(int(kv_lens.max(initial=0)), 1).bit_length() - 1),
                floor)
    ctas = num_kv_heads * -(-tile_q // _KERNEL_ROWS)

    def items(c):
        return _count_items(np.asarray(qo_rows, np.int64),
                            np.asarray(qo_lens, np.int64), kv_lens, group,
                            tile_q, round_up(c, page_size), causal)

    while chunk > floor and items(chunk) * ctas < num_sms:
        chunk //= 2
    return round_up(chunk, page_size)


def _num_sms(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


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
    step uploads its plan in one host-to-device copy. Segments are views.
    A masked plan also holds its work mask (uint8 [T, tile_q,
    kv_chunk_size]) and the mask's tile map (uint8 [T, ceil(tile_q / 64),
    ceil(kv_chunk_size / 64)]). A plan on repacked pages holds the gather map that
    fills its synthetic cache from the caller's (``repack``: int64 [3,
    pages, 128], each slot's page id in the caller's table, its slot in
    that page and its flat token, page * page size + slot) and the caller's
    page size (``repack_page_size``)."""

    blob: torch.Tensor  # [total] int32
    meta: PlanMeta
    work_mask: Optional[torch.Tensor] = None
    repack: Optional[torch.Tensor] = None
    repack_page_size: int = 0
    tile_map: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, meta: PlanMeta, arrays: dict, device: torch.device,
              upload: bool = True) -> "DevicePlan":
        """Pack host arrays (keys: plan = the 12 plan rows, then the other
        segment names, optionally work_mask with tile_map, and repack with
        repack_page_size) into the blob and upload it.
        ``upload=False`` keeps the blob on the host, for a caller that moves
        it up together with its other inputs (the engine writes it into the
        static input buffer of its decode step's CUDA graph)."""
        parts = [np.asarray(a, np.int32).ravel() for a in arrays["plan"]]
        for name, _, _ in meta.blob_layout()[1:]:
            parts.append(np.asarray(arrays[name], np.int32).ravel())
        blob = torch.from_numpy(np.concatenate(parts))
        wm, rp = arrays.get("work_mask"), arrays.get("repack")
        tm = arrays.get("tile_map")
        if wm is not None:
            wm = torch.from_numpy(np.ascontiguousarray(wm, np.uint8))
        if tm is not None:
            tm = torch.from_numpy(np.ascontiguousarray(tm, np.uint8))
        if rp is not None:
            rp = torch.from_numpy(np.ascontiguousarray(rp, np.int64))
        if upload:
            blob = blob.to(device)
            wm, tm, rp = (None if x is None else x.to(device)
                          for x in (wm, tm, rp))
        return cls(blob, meta=meta, work_mask=wm, repack=rp,
                   repack_page_size=int(arrays.get("repack_page_size", 0)),
                   tile_map=tm)

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


def kernel_caches(dplan: DevicePlan, k: torch.Tensor, v: torch.Tensor,
                  kv_layout: TensorLayout, kv_indices_offset: int = 0):
    """(k, v, layout, offset) as the plan's kernel reads the caller's
    caches: the caches themselves, or, for a plan on repacked pages, its
    synthetic NHD cache [pages, 128, kvh, d] gathered from them (the
    offset then rides the gather). Refuses caches whose pages are not the
    size the plan addresses."""
    want = (dplan.meta.page_size if dplan.repack is None
            else dplan.repack_page_size)
    ps = k.shape[2] if kv_layout == TensorLayout.HND else k.shape[1]
    if ps != want:
        raise ValueError(f"the cache has pages of {ps} tokens; the plan "
                         f"addresses pages of {want}")
    if dplan.repack is None:
        return k, v, kv_layout, kv_indices_offset
    page, slot, flat = dplan.repack
    if kv_indices_offset:
        page, flat = page + kv_indices_offset, flat + kv_indices_offset * ps

    def gather(c):  # an NHD cache's tokens are rows, taken by flat index
        if kv_layout == TensorLayout.HND:
            return c[page, :, slot]
        return c.reshape(-1, *c.shape[2:])[flat]
    return gather(k), gather(v), TensorLayout.NHD, 0


def run_device_plan(
    dplan: DevicePlan,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    variant: Optional[AttentionVariant] = None,
    variant_params: Any = None,
    kv_layout: TensorLayout = TensorLayout.HND,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    kv_indices_offset: int = 0,
    return_lse: bool = False,
    kv_dtype: Optional[str] = None,
    workspace: Optional[PartialsWorkspace] = None,
):
    """Execute a DevicePlan. q [nnz, hq, d]; k/v paged caches in
    ``kv_layout``. ``kv_indices_offset`` is added to every page id, so a
    cache that stacks all layers' pages ([L * pages, ...]) is passed whole.
    The cache's dtype says how it is read: ``torch.float8_e4m3fn`` as e4m3,
    int8 as the linear container, or with ``kv_dtype="e4m3"`` as e4m3 bits
    (the JAX package's container; viewed as ``float8_e4m3fn``, no copy),
    as JAX reads them. ``variant`` None is the default softmax (the
    wrappers pass their planned variant, soft cap included). A plan on
    repacked pages gathers its cache first (``kernel_caches``). The split-KV
    partials go to new tensors, or on the card to ``workspace``
    (``PartialsWorkspace``), and merge into the output's layout in one more
    launch (``paged_merge``), whatever the plan's splits."""
    if kv_dtype == "e4m3" and k.dtype == torch.int8:
        k, v = k.view(torch.float8_e4m3fn), v.view(torch.float8_e4m3fn)
    m = dplan.meta
    group = m.num_qo_heads // m.num_kv_heads
    k, v, kv_layout, kv_indices_offset = kernel_caches(
        dplan, k, v, kv_layout, kv_indices_offset)

    partials = (None if workspace is None
                else workspace.partials(m, q.dtype, v.shape[3]))
    partial_o, partial_lse = batch_paged_attention_run(
        pack_queries(dplan, q), k, v, dplan.segment("kv_indices"),
        dplan.segment("plan"), tile_q=m.tile_q, group=m.gqa_group,
        causal=m.causal, sm_scale=m.sm_scale, k_scale=k_scale,
        v_scale=v_scale, window_left=m.window_left, kv_layout=kv_layout,
        kv_indices_offset=kv_indices_offset,
        row_valid=dplan.segment("row_valid"), work_mask=dplan.work_mask,
        variant=variant, variant_params=variant_params,
        tile_map=dplan.tile_map, out=partials,
    )
    out, lse = paged_merge(
        partial_o, partial_lse, dplan.segment("merge_src"),
        dplan.segment("out_map"), tile_q=m.tile_q, group=group,
        nnz=q.shape[0], head_dim_vo=m.head_dim_vo, return_lse=return_lse)
    return (out, lse) if return_lse else out


class PartialsWorkspace:
    """Device memory for the paged kernel's split-KV partials (FlashInfer's
    float workspace buffer), handed to ``run_device_plan``: every call given
    it writes its partials ([T, kvh, tile_q, dv] in q's dtype, then [T, kvh,
    tile_q] f32) into the front of one buffer, so the layers of a step, and
    its eager run and CUDA graph, reuse the same bytes whatever else they
    allocate. Partials larger than the buffer take a new one; a buffer it
    has handed out stays allocated for the workspace's life, since a CUDA
    graph captured over it writes it at every replay. Calls that share a
    workspace run on one stream, one at a time."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs = []

    @property
    def nbytes(self) -> int:
        """Bytes of every buffer it holds."""
        return sum(b.numel() for b in self._bufs)

    def partials(self, meta: PlanMeta, dtype: torch.dtype, dv: int):
        """(o, lse) views for a plan of ``meta`` whose V has ``dv``
        columns."""
        shape = (meta.num_work_items, meta.num_kv_heads, meta.tile_q)
        n = math.prod(shape)
        o_bytes = n * dv * torch.finfo(dtype).bits // 8
        lse_at = -(-o_bytes // 256) * 256
        if not self._bufs or self._bufs[-1].numel() < lse_at + 4 * n:
            self._bufs.append(torch.empty(lse_at + 4 * n, dtype=torch.uint8,
                                          device=self.device))
        buf = self._bufs[-1]
        return (buf[:o_bytes].view(dtype).view(*shape, dv),
                buf[lse_at: lse_at + 4 * n].view(torch.float32).view(shape))


def _chained(q: torch.Tensor, out) -> torch.Tensor:
    """q plus a vanishing multiple of the output: the next timed call then
    waits for this one."""
    o = out[0] if isinstance(out, tuple) else out
    return q + (o.float().sum() * 1e-30).to(q.dtype)


@dataclasses.dataclass
class PlanState:
    plan: AttentionPlan
    device_plan: DevicePlan
    variant: AttentionVariant
    variant_params: Any
    # the caller's page table, lengths and masks, for the reference backend
    host: dict
    # (op key, tactics, plan() arguments) of a derived tile_q the tuner
    # has no winner for: timed at run() inside autotune()
    tune: Optional[tuple] = None


# a prefill plan's tile_q tactics: the paged kernel's tensor-core route
# (128-row CTAs; 64 a half-filled one)
PREFILL_TILE_QS = (64, 128, 256, 512)


def _tuned_tile_q(op_key: str, derived: int, floor: int, choices):
    """(tile_q, tactics or None): the tuner's persisted winner among
    ``choices`` at or above ``floor`` and the derived size, else the
    derived size and those tactics, the derived size first, to time."""
    from flashinfer_tpu_torch.autotuner import AutoTuner

    tactics = [{"tile_q": t} for t in sorted(
        {derived} | {c for c in choices if c >= floor},
        key=lambda t: t != derived)]
    sel = AutoTuner.get().cached(op_key, tactics)
    if sel is not None:
        return sel["tile_q"], None
    return derived, tactics


class BatchAttention:
    """Variable-length paged attention with a plan/run split (JAX's
    ``BatchAttention``). ``tile_k`` is accepted and does nothing: the
    kernel's key tile is fixed by its design (128 keys, 64 where dv > 128).
    ``variant`` replaces the default softmax (and the plan's
    ``logits_soft_cap``)."""

    def __init__(
        self,
        kv_layout: str = "HND",
        *,
        backend: str = "auto",
        tile_q: Optional[int] = None,
        tile_k: int = 512,
        variant: Optional[AttentionVariant] = None,
        device: str | torch.device = "cuda",
    ):
        if backend not in ("auto", "reference"):
            raise ValueError(f"unknown backend {backend!r}: the port runs "
                             "'auto' (its kernel) or 'reference' ('pallas' "
                             "names the TPU kernel)")
        self._layout = check_kv_layout(kv_layout)
        self._backend = backend
        self._tile_q = tile_q
        self._variant = variant
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
        head_dim_vo: Optional[int] = None,
        causal: bool = False,
        sm_scale: Optional[float] = None,
        window_left: int = -1,
        logits_soft_cap: float = 0.0,
        kv_chunk_size: Optional[int] = None,
        kv_len_arr=None,
        variant_params: Any = None,
        work_capacity: Optional[int] = None,
        min_bucket_rows: int = 0,
        min_max_splits: int = 1,
        force_kv_major: Optional[bool] = None,
        custom_mask=None,
        packed_custom_mask=None,
        mask_indptr=None,
        prefix_len_ptr=None,
        token_pos_in_items_ptr=None,
        token_pos_in_items_len: int = 0,
        max_item_len_ptr=None,
        defer_upload: bool = False,
        **_ignored,
    ):
        """Host-side plan. Index arguments are host arrays (a tensor on any
        device is read back). ``min_bucket_rows`` floors the padded-row
        bucket; ``min_max_splits`` the merge's split dimension (a power of
        two), so plans of growing lengths can share one ``PlanMeta``;
        ``force_kv_major`` pins the prefill item order. Masks:
        ``custom_mask`` (bool, the requests' [qo, kv] masks concatenated) or
        ``packed_custom_mask`` (their bits, packed "big"), with
        ``mask_indptr`` the requests' bit offsets; or multi-item scoring
        (``prefix_len_ptr``, ``token_pos_in_items_ptr``,
        ``token_pos_in_items_len``; ``max_item_len_ptr`` is a hint, unread).
        ``defer_upload`` leaves the plan's blob on the host; workspace
        buffers and other keywords of the reference go to ``_ignored``."""
        # the arguments, to plan again with another tile_q when tuning
        call = {k: v for k, v in locals().items()
                if k not in ("self", "_ignored")}
        call.update(_ignored)
        qo_indptr = _host(qo_indptr, np.int64)
        kv_indptr = _host(kv_indptr, np.int64)
        kv_indices_np = _host(kv_indices, np.int64)
        batch = len(qo_indptr) - 1
        head_dim_vo = head_dim_vo or head_dim_qk
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(head_dim_qk)
        if num_qo_heads % num_kv_heads:
            raise ValueError(f"{num_qo_heads} q heads are not a multiple of "
                             f"{num_kv_heads} kv heads")
        group = num_qo_heads // num_kv_heads

        if kv_len_arr is not None:
            kv_lens = _host(kv_len_arr, np.int64)
        else:
            last = _host(kv_last_page_len, np.int64)
            npages = kv_indptr[1:] - kv_indptr[:-1]
            kv_lens = np.where(npages > 0, (npages - 1) * page_size + last, 0)
        host = dict(qo_indptr=qo_indptr, kv_indptr=kv_indptr,
                    kv_indices=kv_indices_np, kv_lens=kv_lens,
                    page_size=page_size)

        # pages under 8 tokens: the plan is built on a synthetic cache of
        # 128-token pages, one gather at run() fills it (JAX's tiny-page
        # repack)
        repack = None
        if page_size < 8:
            syn_pages = -(-np.maximum(kv_lens, 0) // _SYN_PAGE)
            syn_indptr = np.concatenate([[0], np.cumsum(syn_pages)])
            n_syn = int(syn_indptr[-1])
            r_of_page = np.repeat(np.arange(batch), syn_pages)
            page_in_req = np.arange(n_syn) - syn_indptr[r_of_page]
            t = page_in_req[:, None] * _SYN_PAGE + np.arange(_SYN_PAGE)
            t = np.minimum(t, np.maximum(kv_lens[r_of_page][:, None] - 1, 0))
            flat = kv_indptr[r_of_page][:, None] + t // page_size
            tok_page = kv_indices_np[np.minimum(flat,
                                                len(kv_indices_np) - 1)]
            # [n_syn, 128] page, slot and flat token of each synthetic
            # slot; slots past a request's end repeat its last token, which
            # no row reads
            slot = t % page_size
            repack = dict(repack=np.stack([tok_page, slot,
                                           tok_page * page_size + slot]),
                          repack_page_size=page_size)
            kv_indptr = syn_indptr.astype(np.int64)
            kv_indices_np = np.arange(max(n_syn, 1), dtype=np.int64)
            page_size = _SYN_PAGE

        qo_lens = qo_indptr[1:] - qo_indptr[:-1]
        qo_token_total = int(qo_indptr[-1])

        # decode-like batches get a group-sized tile, prefill rows larger ones
        avg_packed = max(1, int((qo_lens * group).mean())) if batch else 1
        tile_q = self._tile_q or min(512, max(8, next_power_of_2(avg_packed)))
        tile_q = max(tile_q, next_power_of_2(group), 8)
        packed_lens = qo_lens * group
        tune = None
        if self._tile_q is None and tile_q >= PREFILL_TILE_QS[0]:
            masked = (custom_mask is not None or packed_custom_mask is not None
                      or prefix_len_ptr is not None)
            key = (f"paged_prefill_tile_q::h{num_qo_heads}x{num_kv_heads}"
                   f"::d{head_dim_qk}x{head_dim_vo}::ps{page_size}"
                   f"::causal{int(causal)}::mask{int(masked)}::rows"
                   f"{next_power_of_2(int(packed_lens.sum()))}")
            floor = max(next_power_of_2(group), 8)
            tile_q, tactics = _tuned_tile_q(key, tile_q, floor,
                                            PREFILL_TILE_QS)
            if tactics is not None:
                tune = (key, tactics, call)

        padded_lens = np.maximum(round_up(packed_lens, tile_q), 0)
        padded_indptr = np.concatenate([[0], np.cumsum(padded_lens)])
        total_padded = int(padded_indptr[-1])
        bucket_rows = max(_bucket(max(total_padded, tile_q)), min_bucket_rows)

        # prefill batches take the reference's kv-major item order; the
        # blob then matches the reference's bit for bit
        prefill_mode = (force_kv_major if force_kv_major is not None
                        else bool(np.any(packed_lens > tile_q)))

        def planned(chunk):
            return plan_attention(
                padded_indptr, kv_lens, qo_token_lens=qo_lens,
                gqa_group=group, kv_indptr=kv_indptr, page_size=page_size,
                tile_q=tile_q, kv_chunk_size=chunk,
                work_capacity=work_capacity, causal=causal)

        chunk = kv_chunk_size
        if chunk is None and prefill_mode:
            chunk = prefill_kv_chunk(
                padded_lens, qo_lens, kv_lens, group=group, tile_q=tile_q,
                page_size=page_size, num_kv_heads=num_kv_heads,
                causal=causal, num_sms=_num_sms(self._device))
        plan = planned(chunk)
        if prefill_mode:
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

        # per-request custom / multi-item masks, legalised once here into
        # the work items' tiling (1 byte a (row, key) of each item)
        req_masks = None
        if packed_custom_mask is not None or custom_mask is not None:
            if prefix_len_ptr is not None:
                raise ValueError("custom_mask and multi-item scoring are "
                                 "mutually exclusive")
            req_masks = _unpack_request_masks(
                packed_custom_mask, custom_mask, mask_indptr, qo_lens,
                kv_lens)
        elif prefix_len_ptr is not None:
            if not causal:
                raise ValueError("multi-item scoring implies causal masking")
            tpos = _host(token_pos_in_items_ptr, np.int64)
            req_masks = _multi_item_masks(
                qo_lens, kv_lens, _host(prefix_len_ptr, np.int64), tpos,
                int(token_pos_in_items_len) or tpos.size)
        host["req_masks"] = req_masks
        work_mask = tile_map = None
        if req_masks is not None:
            work_mask = _build_work_mask(plan, req_masks, group)
            tile_map = paged_tile_map(
                torch.from_numpy(np.stack(plan.prefetch_arrays()).astype(
                    np.int32)), torch.from_numpy(work_mask),
                tile_q=plan.tile_q,
                group=group, causal=causal, window_left=window_left,
                q_rows=bucket_rows,
                row_valid=torch.from_numpy(valid_row.astype(np.int32)))

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
            has_mask=work_mask is not None,
        )
        device_plan = DevicePlan.build(
            meta,
            dict(plan=plan.prefetch_arrays(), kv_indices=kv_idx_host,
                 row_src=row_src, row_valid=valid_row,
                 merge_out_row=plan.merge_out_row, out_map=out_map,
                 merge_src=merge_src, work_mask=work_mask, tile_map=tile_map,
                 **(repack or {})),
            self._device, upload=not defer_upload,
        )
        variant = self._variant or make_default_variant(
            logits_soft_cap=logits_soft_cap)
        self._state = PlanState(plan, device_plan, variant, variant_params,
                                host, tune)
        return self

    def _replan(self, call: dict, tactic: dict) -> None:
        """Plan ``call`` again with ``tactic``'s tile_q pinned."""
        pinned, self._tile_q = self._tile_q, tactic["tile_q"]
        try:
            BatchAttention.plan(self, **call)
        finally:
            self._tile_q = pinned

    @property
    def device_plan(self) -> Optional[DevicePlan]:
        """The plan as run_device_plan takes it."""
        return self._state.device_plan if self._state else None

    def _planned(self) -> PlanState:
        if self._state is None:
            raise RuntimeError("call plan() before run()")
        return self._state

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
        of paged caches in the wrapper's layout. ``k_scale`` / ``v_scale``
        dequantise 8-bit caches."""
        st = self._planned()
        if q.shape[0] != st.device_plan.meta.nnz:
            raise ValueError(f"q rows {q.shape[0]} != planned "
                             f"{st.device_plan.meta.nnz}")
        if self._backend == "reference":
            return self._run_reference(q, self._request_keys(kv_cache),
                                       return_lse, k_scale, v_scale)
        k, v = kv_cache

        def launch(q_):
            s_ = self._state
            return run_device_plan(
                s_.device_plan, q_, k, v, variant=s_.variant,
                variant_params=s_.variant_params, kv_layout=self._layout,
                k_scale=k_scale, v_scale=v_scale, return_lse=return_lse)

        if st.tune is not None:
            from flashinfer_tpu_torch.autotuner import AutoTuner, \
                tune_replanned

            if AutoTuner.get().enabled:
                key, tactics, call = st.tune
                tune_replanned(key, tactics,
                               lambda t: self._replan(call, t),
                               lambda c: _chained(c, launch(c)), q)
        return launch(q)

    def _request_keys(self, kv_cache):
        """Request r's keys and values [kv_len, kvh, d] from the caller's
        page table."""
        k_cache, v_cache = kv_cache
        h = self._state.host
        ps = h["page_size"]
        if self._layout == TensorLayout.HND:
            k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)

        def keys(r):
            ind = h["kv_indptr"]
            pages = torch.from_numpy(h["kv_indices"][ind[r]:ind[r + 1]]).to(
                k_cache.device)
            n = int(h["kv_lens"][r])
            return tuple(c[pages].reshape(len(pages) * ps, *c.shape[2:])[:n]
                         for c in (k_cache, v_cache))
        return keys

    def _run_reference(self, q, keys, return_lse, k_scale=1.0, v_scale=1.0):
        """The oracle request by request (JAX's ``_run_reference``): the
        dense ``attention_reference`` over each request's keys, with its
        mask and the planned variant; 8-bit caches dequantised first."""
        st = self._state
        h, m = st.host, st.device_plan.meta
        qo_indptr, masks = h["qo_indptr"], h["req_masks"]
        outs, lses = [], []
        for r in range(len(qo_indptr) - 1):
            k_r, v_r = keys(r)
            if k_r.dtype != q.dtype:
                k_r = (k_r.float() * k_scale).to(q.dtype)
                v_r = (v_r.float() * v_scale).to(q.dtype)
            o, lse = attention_reference(
                q[qo_indptr[r]:qo_indptr[r + 1]], k_r, v_r, causal=m.causal,
                sm_scale=m.sm_scale, window_left=m.window_left,
                custom_mask=(None if masks is None else
                             torch.from_numpy(masks[r]).to(q.device)),
                variant=st.variant, variant_params=st.variant_params)
            outs.append(o)
            lses.append(lse)
        if not outs:
            return ((q[:0], q.new_zeros(0, q.shape[1], dtype=torch.float32))
                    if return_lse else q[:0])
        out = torch.cat(outs)
        return (out, torch.cat(lses)) if return_lse else out


class BatchPrefillWithPagedKVCacheWrapper(BatchAttention):
    """Prefill (and append) over a paged cache; qo_indptr gives each
    request's query tokens. The reference's leading workspace buffer is
    accepted and unused."""

    def __init__(self, float_workspace_buffer=None, kv_layout: str = "HND",
                 **kw):
        super().__init__(kv_layout=kv_layout, **kw)

    def plan(self, qo_indptr, paged_kv_indptr, paged_kv_indices,
             paged_kv_last_page_len, num_qo_heads, num_kv_heads, head_dim_qk,
             page_size, **kwargs):
        """``BatchAttention.plan`` under the reference's names of the page
        table (JAX's too), so calls by keyword reach it."""
        return super().plan(qo_indptr, paged_kv_indptr, paged_kv_indices,
                            paged_kv_last_page_len, num_qo_heads,
                            num_kv_heads, head_dim_qk, page_size, **kwargs)


class BatchDecodeWithPagedKVCacheWrapper(BatchAttention):
    """One query token per request. The GQA group rides the packed-row
    dimension, as in the reference's tensor-core decode path."""

    def __init__(self, float_workspace_buffer=None, kv_layout: str = "HND",
                 **kw):
        super().__init__(kv_layout=kv_layout, **kw)

    def plan(self, indptr, indices, last_page_len, num_qo_heads,
             num_kv_heads, head_dim, page_size, **kwargs):
        batch = len(_host(indptr)) - 1
        kwargs.setdefault("causal", False)
        return super().plan(np.arange(batch + 1), indptr, indices,
                            last_page_len, num_qo_heads, num_kv_heads,
                            head_dim, page_size, **kwargs)


class BatchPrefillWithRaggedKVCacheWrapper(BatchAttention):
    """Contiguous KV [total_kv, num_kv_heads, head_dim] addressed by a token
    indptr. The KV is planned as NHD pages of one token ([total_kv, 1, kvh,
    d], a view), so ``plan`` builds JAX's paged plan over 128-token pages
    (the blob is JAX's) and ``run`` gathers K and V into them, then runs
    the paged kernel."""

    def __init__(self, float_workspace_buffer=None, kv_layout: str = "NHD",
                 **kw):
        super().__init__(kv_layout="NHD", **kw)

    def plan(self, qo_indptr, kv_indptr, num_qo_heads, num_kv_heads,
             head_dim_qk, **kwargs):
        kv_indptr = _host(kv_indptr, np.int64)
        kv_lens = kv_indptr[1:] - kv_indptr[:-1]
        return super().plan(qo_indptr, kv_indptr, np.arange(kv_indptr[-1]),
                            (kv_lens > 0).astype(np.int64), num_qo_heads,
                            num_kv_heads, head_dim_qk, 1, **kwargs)

    def run(self, q, k, v=None, **kwargs):
        """q [nnz, hq, d]; k and v [total_kv, kvh, d] (or run(q, (k, v)));
        ``kwargs`` as ``BatchAttention.run`` takes them."""
        if v is None:
            k, v = k
        return super().run(q, (k[:, None], v[:, None]), **kwargs)


class BatchAttentionWithAttentionSinkWrapper(BatchAttention):
    """GPT-OSS attention sinks: an extra logit a head joins the softmax's
    denominator. As in JAX, the batch runs with its lse and then merges
    the sink's state (v = 0, s = sink) into every output row."""

    def __init__(self, sink, kv_layout: str = "HND", **kw):
        super().__init__(kv_layout=kv_layout, **kw)
        self._sink = torch.as_tensor(sink, dtype=torch.float32).to(
            self._device)

    def run(self, q, kv_cache, *, return_lse: bool = False, **kwargs):
        out, lse = super().run(q, kv_cache, return_lse=True, **kwargs)
        sink = self._sink.to(lse.device)[None, :].expand_as(lse)
        out, lse = merge_state(out, lse, torch.zeros_like(out), sink)
        return (out, lse) if return_lse else out
