"""DeepSeek MLA (matrix-absorbed multi-head latent attention), paged.

Counterpart of flashinfer_tpu/ops/attention/mla.py. Matrix-absorbed MLA is
MQA with a compressed KV row ckv (d_ckv, which is also V) and a rope row
kpe (d_kpe): score = q_nope.ckv + q_pe.kpe, out = P.ckv. All num_heads
query heads are packed as rows of one KV stream (kv heads 1, ``gqa_group``
= num_heads), so the plan is the paged attention plan (``PlanMeta``,
``DevicePlan``, the same int32 blob as the JAX package's).

``mla_paged_run`` launches the CUDA kernels of ``flashinfer_tpu_torch/csrc/
mla_attention.cu``, which replace the TPU kernel ``_mla_kernel`` (mla.py:67,
launched by ``_mla_paged_run`` :372): wgmma tiles fed by TMA for bf16 q at
DeepSeek's widths, the CUDA cores otherwise (``mla_route`` says which);
``mla_paged_plain`` is their plain version. The cache's dtype says how it
is read: the model dtype, ``torch.float8_e4m3fn`` (e4m3; the JAX package's int8 containers of e4m3
bits are the same bytes, ``.view(torch.float8_e4m3fn)``), or int8 as the
linear container (value = q * scale).

The wrapper's rows a work item (``tile_q``), where the caller did not pin
them and they reach the prefill route's 64-row tiles, come from the
autotuner (``MLA_PREFILL_TILE_QS``), as ``BatchAttention``'s prefill tiles
do: the counterpart of JAX's tuned MLA ``tile_k`` (mla.py:400-440).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.ops.attention.batch import (
    DevicePlan,
    PlanMeta,
    _bucket,
    _chained,
    _tuned_tile_q,
)
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.state import gather_merge_states
from flashinfer_tpu_torch.scheduler.plan import build_merge_src, plan_attention
from flashinfer_tpu_torch.utils import (
    next_power_of_2,
    resolve_device,
    round_up,
)

# an MLA prefill plan's tile_q tactics: the prefill route's 64-row tiles
# (tile_q 64 and 128 measured within 5% of each other at V2-Lite's causal
# prefill on the H100: PERF.md)
MLA_PREFILL_TILE_QS = (64, 128)

__all__ = ["BatchMLAPagedAttentionWrapper", "mla_paged_run",
           "mla_paged_plain", "mla_route"]

# rows of the plan that the kernels read (AttentionPlan.prefetch_arrays)
_REQ, _QO_TILE, _QO_START, _KV_START, _KV_END, _KV_PAGE_START, _Q_POS_BASE = (
    0, 1, 3, 5, 6, 7, 9)
# dtype codes of the C entry point (csrc/mla_attention.cu)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_E4M3, _KV_I8 = 2, 3
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _kv_format(c: torch.Tensor) -> str:
    if c.dtype == torch.float8_e4m3fn:
        return "e4m3"
    if c.dtype == torch.int8:
        return "int8"
    return "model"


def mla_paged_plain(
    q_ckv: torch.Tensor,
    q_pe: torch.Tensor,
    ckv_cache: torch.Tensor,
    kpe_cache: torch.Tensor,
    kv_indices: torch.Tensor,
    plan: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    causal: bool,
    sm_scale: float,
    v_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The work list in plain PyTorch, all items at once: each item's KV
    chunk is gathered page by page and attended in one softmax pass.
    Rounding as on the TPU: keys convert exactly; P goes into P.V in bf16
    unless the cache is f32, against the row's max as the TPU kernel
    rounds it below 8 keys (the kernels round against their exact running
    max: a bf16 step apart on some P); q is rounded to bf16 against an
    e4m3 cache. sm_scale and v_scale arrive with the 8-bit
    scales folded in."""
    fmt = _kv_format(ckv_cache)
    q_rows, d_ckv = q_ckv.shape
    d_kpe = q_pe.shape[1]
    dev = q_ckv.device
    ps = ckv_cache.shape[1]
    p = plan.reshape(12, -1).long()
    T = p.shape[1]
    kv_start = p[_KV_START]
    span = torch.where(p[_REQ] >= 0, (p[_KV_END] - kv_start).clamp(min=0), 0)
    out_o = torch.zeros(T, tile_q, d_ckv, dtype=q_ckv.dtype, device=dev)
    out_lse = torch.full((T, tile_q), float("-inf"), device=dev)
    max_span = int(span.max()) if T else 0
    if max_span == 0:
        return out_o, out_lse
    npages = -(-max_span // ps)
    C = npages * ps
    pidx = (p[_KV_PAGE_START][:, None]
            + torch.arange(npages, device=dev)[None, :])
    pages = kv_indices.long()[pidx.clamp(0, kv_indices.numel() - 1)]
    ckv = ckv_cache[pages].reshape(T, C, d_ckv).float()
    kpe = kpe_cache[pages][..., :d_kpe].reshape(T, C, d_kpe).float()

    rows = p[_QO_START][:, None] + torch.arange(tile_q, device=dev)[None, :]
    rows = rows.clamp(max=q_rows - 1)
    qc, qp = q_ckv[rows].float(), q_pe[rows].float()  # [T, tile_q, d]
    if fmt == "e4m3":
        qc, qp = qc.bfloat16().float(), qp.bfloat16().float()
    s = (torch.einsum("trd,tcd->trc", qc, ckv)
         + torch.einsum("trd,tcd->trc", qp, kpe)) * (sm_scale * _LOG2E)
    col = torch.arange(C, device=dev)
    mask = (col[None, :] < span[:, None])[:, None, :]  # [T, 1, C]
    if causal:
        kv_pos = kv_start[:, None] + col[None, :]
        q_tok = p[_Q_POS_BASE][:, None] + (
            p[_QO_TILE][:, None] * tile_q
            + torch.arange(tile_q, device=dev)[None, :]) // group
        mask = mask & (kv_pos[:, None, :] <= q_tok[:, :, None])
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    pr = torch.where(mask, torch.exp2(s - m_safe), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    if ckv_cache.dtype != torch.float32:
        pr = pr.bfloat16().float()
    pv = torch.einsum("trc,tcd->trd", pr, ckv)
    safe_l = torch.where(l > 0, l, 1.0)
    o = pv / safe_l * v_scale
    lse = torch.where(l > 0, m_safe * _LN2 + torch.log(safe_l), float("-inf"))
    return o.to(q_ckv.dtype), lse[..., 0]


def _lib():
    fn = jit.load("mla_attention").fi_mla_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, P,  # q_ckv q_pe ckv kpe plan idx o lse
                       I, I, I, I, I, I, I, I,  # T rows tq d_ckv d_kpe stride ps grp
                       F, F, I, I, I, P]  # scales causal dtypes stream
        fn.restype = I
    return fn


_ROUTES = ("cuda_cores", "decode", "prefill")


def mla_route(q_dtype: torch.dtype, kv_dtype: torch.dtype, tile_q: int,
              d_ckv: int, d_kpe: int, page_size: int) -> str:
    """The kernel ``mla_paged_run`` launches for these arguments, as the
    library's C entry chooses it: "decode" (swap-AB wgmma tiles, tile_q
    8/16/32) or "prefill" (64-row wgmma tiles, tile_q a multiple of 64) for
    bf16 q at DeepSeek's widths (d_ckv 512, d_kpe 64) on pages of a multiple
    of 8 tokens, else "cuda_cores". Needs the library (a CUDA machine)."""
    fn = jit.load("mla_attention").fi_mla_route
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    kv_code = {torch.float8_e4m3fn: _KV_E4M3, torch.int8: _KV_I8}.get(
        kv_dtype, _Q_CODES.get(kv_dtype, -1))
    return _ROUTES[fn(_Q_CODES.get(q_dtype, -1), kv_code, tile_q, d_ckv,
                      d_kpe, page_size)]


def mla_paged_run(
    q_ckv: torch.Tensor,
    q_pe: torch.Tensor,
    ckv_cache: torch.Tensor,
    kpe_cache: torch.Tensor,
    kv_indices: torch.Tensor,
    plan: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    causal: bool,
    sm_scale: float,
    v_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the planned MLA work list. q_ckv [rows, d_ckv] and q_pe [rows,
    d_kpe] packed by (token, head) rows, tile_q-aligned per request;
    ckv_cache [P, page_size, d_ckv]; kpe_cache [P, page_size, >= d_kpe]
    (a pre-padded cache is read through its row stride); kv_indices int32;
    plan int32 [12 * T]. Returns partial o [T, tile_q, d_ckv] (q's dtype)
    and lse [T, tile_q] f32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``mla_paged_plain``."""
    kw = dict(tile_q=tile_q, group=group, causal=causal, sm_scale=sm_scale,
              v_scale=v_scale)
    if not q_ckv.is_cuda:
        return mla_paged_plain(q_ckv, q_pe, ckv_cache, kpe_cache, kv_indices,
                               plan, **kw)
    fmt = _kv_format(ckv_cache)
    q_rows, d_ckv = q_ckv.shape
    d_kpe = q_pe.shape[1]
    if q_ckv.dtype not in _Q_CODES or q_pe.dtype != q_ckv.dtype:
        raise TypeError(f"MLA kernel takes bf16/f32 q, got {q_ckv.dtype} "
                        f"and {q_pe.dtype}")
    if kpe_cache.dtype != ckv_cache.dtype:
        raise TypeError("ckv and kpe caches differ in dtype")
    if fmt == "model" and ckv_cache.dtype != q_ckv.dtype:
        raise TypeError(f"cache {ckv_cache.dtype} does not match q "
                        f"{q_ckv.dtype}")
    stride = kpe_cache.shape[2]
    if (d_ckv > 512 or d_ckv % 16 or d_kpe > 128 or d_kpe % 16
            or ckv_cache.shape[2] != d_ckv or stride < d_kpe
            or (stride * kpe_cache.element_size()) % 16
            or tile_q % 8 or (tile_q >= 16 and tile_q % 16)):
        raise ValueError(
            f"MLA kernel takes d_ckv <= 512 and d_kpe <= 128 (multiples of "
            f"16), a kpe row stride of whole 16-byte vectors and tile_q 8 or "
            f"a multiple of 16; got q_ckv {tuple(q_ckv.shape)}, q_pe "
            f"{tuple(q_pe.shape)}, ckv {tuple(ckv_cache.shape)}, kpe "
            f"{tuple(kpe_cache.shape)}, tile_q {tile_q}")
    for t, name in ((ckv_cache, "ckv_cache"), (kpe_cache, "kpe_cache"),
                    (kv_indices, "kv_indices"), (plan, "plan")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if ckv_cache.data_ptr() % 16 or kpe_cache.data_ptr() % 16:
        raise ValueError("the MLA kernels read the caches in 16-byte vectors "
                         "(and through TMA): they must start on 16 bytes")
    if kv_indices.dtype != torch.int32 or plan.dtype != torch.int32:
        raise TypeError("plan and kv_indices must be int32")
    T = plan.numel() // 12
    q_ckv, q_pe = q_ckv.contiguous(), q_pe.contiguous()
    o = torch.empty(T, tile_q, d_ckv, dtype=q_ckv.dtype, device=q_ckv.device)
    lse = torch.empty(T, tile_q, dtype=torch.float32, device=q_ckv.device)
    kv_code = {"model": _Q_CODES[q_ckv.dtype], "e4m3": _KV_E4M3,
               "int8": _KV_I8}[fmt]
    err = _lib()(
        q_ckv.data_ptr(), q_pe.data_ptr(), ckv_cache.data_ptr(),
        kpe_cache.data_ptr(), plan.data_ptr(), kv_indices.data_ptr(),
        o.data_ptr(), lse.data_ptr(), T, q_rows, tile_q, d_ckv, d_kpe,
        stride, ckv_cache.shape[1], group, float(sm_scale), float(v_scale),
        int(causal), _Q_CODES[q_ckv.dtype], kv_code,
        torch.cuda.current_stream(q_ckv.device).cuda_stream)
    jit.check(err, "MLA attention kernel")
    mla_paged_run.launches += 1
    return o, lse


mla_paged_run.launches = 0


class BatchMLAPagedAttentionWrapper:
    """Plan/run MLA over paged (ckv, kpe) caches (flashinfer_tpu/ops/
    attention/mla.py:556).

    plan(qo_indptr, kv_indptr, kv_indices, kv_len_arr, num_heads,
         head_dim_ckv, head_dim_kpe, page_size, causal, sm_scale)
    run(q_nope [nnz, h, d_ckv], q_pe [nnz, h, d_kpe], ckv_cache
        [pages, page_size, d_ckv], kpe_cache [pages, page_size, d_kpe])

    ``backend="reference"`` runs the per-request dense oracle; "auto"
    runs the kernel (its plain version on CPU tensors)."""

    def __init__(self, *, backend: str = "auto", tile_q: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        if backend not in ("auto", "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        self._backend = backend
        self._tile_q = tile_q
        self._device = resolve_device(device)
        self._state = None
        self._tune = None
        self.device_plan: Optional[DevicePlan] = None

    def plan(
        self,
        qo_indptr,
        kv_indptr,
        kv_indices,
        kv_len_arr,
        num_heads: int,
        head_dim_ckv: int,
        head_dim_kpe: int,
        page_size: int,
        *,
        causal: bool = False,
        sm_scale: Optional[float] = None,
        kv_chunk_size: Optional[int] = None,
        **_ignored,
    ):
        """Host-side plan (NumPy), uploaded as one int32 blob."""
        # the arguments, to plan again with another tile_q when tuning
        call = {k: v for k, v in locals().items()
                if k not in ("self", "_ignored")}
        call.update(_ignored)
        qo_indptr = np.asarray(qo_indptr, np.int64)
        kv_indptr = np.asarray(kv_indptr, np.int64)
        kv_indices_np = np.asarray(kv_indices, np.int64)
        kv_lens = np.asarray(kv_len_arr, np.int64)
        batch = len(qo_indptr) - 1
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(head_dim_ckv + head_dim_kpe)
        group = num_heads

        qo_lens = qo_indptr[1:] - qo_indptr[:-1]
        nnz = int(qo_indptr[-1])
        avg_packed = max(1, int((qo_lens * group).mean())) if batch else 1
        tile_q = self._tile_q or min(128, max(8, next_power_of_2(avg_packed)))
        tile_q = min(128, max(tile_q, 8))
        packed_lens = qo_lens * group
        self._tune = None
        if self._tile_q is None and tile_q >= MLA_PREFILL_TILE_QS[0]:
            key = (f"mla_prefill_tile_q::h{num_heads}::ckv{head_dim_ckv}"
                   f"xkpe{head_dim_kpe}::ps{page_size}::causal{int(causal)}"
                   f"::rows{next_power_of_2(int(packed_lens.sum()))}")
            tile_q, tactics = _tuned_tile_q(key, tile_q, 64,
                                            MLA_PREFILL_TILE_QS)
            if tactics is not None:
                self._tune = (key, tactics, call)

        padded_lens = np.maximum(round_up(packed_lens, tile_q), 0)
        padded_indptr = np.concatenate([[0], np.cumsum(padded_lens)])
        total_padded = int(padded_indptr[-1])
        bucket_rows = _bucket(max(total_padded, tile_q))

        plan = plan_attention(
            padded_indptr, kv_lens, qo_token_lens=qo_lens, gqa_group=group,
            kv_indptr=kv_indptr, page_size=page_size, tile_q=tile_q,
            kv_chunk_size=kv_chunk_size, causal=causal,
        )

        rows = np.arange(bucket_rows)
        req_of_row = np.clip(
            np.searchsorted(padded_indptr, rows, side="right") - 1, 0,
            batch - 1)
        local = rows - padded_indptr[req_of_row]
        valid_row = (local < packed_lens[req_of_row]) & (rows < total_padded)
        token = qo_indptr[req_of_row] + local // group
        row_src = np.where(valid_row, token * group + local % group, 0)

        tg = np.arange(nnz * group)
        tok = tg // group
        req_of_tok = np.clip(
            np.searchsorted(qo_indptr, tok, side="right") - 1, 0, batch - 1)
        out_map = (padded_indptr[req_of_tok]
                   + (tok - qo_indptr[req_of_tok]) * group + tg % group)

        padded_idx = np.zeros(_bucket(max(len(kv_indices_np), 1)), np.int32)
        padded_idx[: len(kv_indices_np)] = kv_indices_np
        merge_src = build_merge_src(plan.merge_out_row, bucket_rows)
        meta = PlanMeta(
            tile_q=plan.tile_q,
            kv_chunk_size=plan.kv_chunk_size,
            num_work_items=plan.num_work_items,
            page_size=page_size,
            gqa_group=plan.gqa_group,
            bucket_rows=bucket_rows,
            nnz=nnz,
            num_qo_heads=num_heads,
            num_kv_heads=1,
            head_dim_qk=head_dim_ckv + head_dim_kpe,
            head_dim_vo=head_dim_ckv,
            causal=causal,
            sm_scale=sm_scale,
            window_left=-1,
            ragged=False,
            kv_indices_len=int(padded_idx.shape[0]),
            max_splits=int(merge_src.shape[1]),
        )
        self.device_plan = DevicePlan.build(
            meta,
            dict(plan=plan.prefetch_arrays(), kv_indices=padded_idx,
                 row_src=row_src, row_valid=valid_row,
                 merge_out_row=plan.merge_out_row, out_map=out_map,
                 merge_src=merge_src),
            self._device,
        )
        self._state = dict(qo_indptr=qo_indptr, kv_indptr=kv_indptr,
                           kv_indices=kv_indices_np, kv_lens=kv_lens)
        return self

    def _replan(self, call: dict, tactic: dict) -> None:
        """Plan ``call`` again with ``tactic``'s tile_q pinned."""
        pinned, self._tile_q = self._tile_q, tactic["tile_q"]
        try:
            BatchMLAPagedAttentionWrapper.plan(self, **call)
        finally:
            self._tile_q = pinned

    def run(
        self,
        q_nope: torch.Tensor,
        q_pe: torch.Tensor,
        ckv_cache: torch.Tensor,
        kpe_cache: torch.Tensor,
        *,
        return_lse: bool = False,
        ckv_scale: float = 1.0,
        kpe_scale: float = 1.0,
        cache_dtype: str = "e4m3",
    ):
        """ckv_scale/kpe_scale dequantize 8-bit caches (e4m3 or linear
        int8); they fold into the softmax scale and the output (q_pe is
        prescaled by kpe_scale / ckv_scale when they differ).

        ``cache_dtype`` says how an int8 cache is read, as in JAX:
        "e4m3" (the default) as e4m3 bits, viewed as
        ``torch.float8_e4m3fn`` without a copy; "int8" as linear int8
        (value = q * scale). A ``float8_e4m3fn`` cache ignores it."""
        if self._state is None:
            raise RuntimeError("call plan() before run()")
        if cache_dtype not in ("e4m3", "int8"):
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
        if cache_dtype == "e4m3":
            ckv_cache, kpe_cache = (
                c.view(torch.float8_e4m3fn) if c.dtype == torch.int8 else c
                for c in (ckv_cache, kpe_cache))
        if self._backend == "reference":
            return self._run_reference(q_nope, q_pe, ckv_cache, kpe_cache,
                                       return_lse, ckv_scale, kpe_scale)
        if self._tune is not None:
            from flashinfer_tpu_torch.autotuner import AutoTuner, \
                tune_replanned

            if AutoTuner.get().enabled:
                key, tactics, call = self._tune
                tune_replanned(
                    key, tactics, lambda t: self._replan(call, t),
                    lambda c: _chained(c, self._launch(
                        c, q_pe, ckv_cache, kpe_cache, return_lse,
                        ckv_scale, kpe_scale)), q_nope)
        return self._launch(q_nope, q_pe, ckv_cache, kpe_cache, return_lse,
                            ckv_scale, kpe_scale)

    def _launch(self, q_nope, q_pe, ckv_cache, kpe_cache, return_lse,
                ckv_scale, kpe_scale):
        dp = self.device_plan
        m = dp.meta
        nnz, h, d_ckv = q_nope.shape
        d_kpe = q_pe.shape[-1]
        if nnz != m.nnz:
            raise ValueError(f"q rows {nnz} != planned {m.nnz}")
        sm_scale, v_scale = m.sm_scale, 1.0
        if _kv_format(ckv_cache) != "model":
            if kpe_scale != ckv_scale:
                q_pe = q_pe * torch.tensor(kpe_scale / ckv_scale,
                                           dtype=q_pe.dtype)
            sm_scale = sm_scale * ckv_scale
            v_scale = ckv_scale

        row_src = dp.segment("row_src").long()
        row_valid = dp.segment("row_valid") != 0

        def pack(x, d):  # rows are (token, head) pairs
            return torch.where(row_valid[:, None],
                               x.reshape(nnz * h, d)[row_src], 0)

        partial_o, partial_lse = mla_paged_run(
            pack(q_nope, d_ckv), pack(q_pe, d_kpe), ckv_cache, kpe_cache,
            dp.segment("kv_indices"), dp.segment("plan"), tile_q=m.tile_q,
            group=m.gqa_group, causal=m.causal, sm_scale=sm_scale,
            v_scale=v_scale)
        merged_o, merged_lse = gather_merge_states(
            partial_o[:, None], partial_lse[:, None], dp.segment("merge_src"),
            m.tile_q)
        out_map = dp.segment("out_map").long()
        out = merged_o[:, 0][out_map].reshape(nnz, h, d_ckv)
        if return_lse:
            return out, merged_lse[:, 0][out_map].reshape(nnz, h)
        return out

    def _run_reference(self, q_nope, q_pe, ckv_cache, kpe_cache, return_lse,
                       ckv_scale, kpe_scale):
        """The dense oracle, request by request. It reads the caches as
        ``run`` hands them over: an int8 cache that reaches it is linear
        (``cache_dtype="int8"``); the JAX package's reads every int8 cache
        as e4m3 bits (mla.py:805-810), as ``run``'s default does."""
        st = self._state
        d_ckv, d_kpe = q_nope.shape[-1], q_pe.shape[-1]

        def deq(c, scale):
            if c.dtype in (torch.int8, torch.float8_e4m3fn):
                return c.float() * scale
            return c

        ckv_cache = deq(ckv_cache, ckv_scale)
        kpe_cache = deq(kpe_cache, kpe_scale)
        q = torch.cat([q_nope, q_pe], dim=-1)
        outs, lses = [], []
        for r in range(len(st["qo_indptr"]) - 1):
            q_r = q[st["qo_indptr"][r]: st["qo_indptr"][r + 1]]
            kv_len = int(st["kv_lens"][r])
            pages = torch.from_numpy(
                st["kv_indices"][st["kv_indptr"][r]: st["kv_indptr"][r + 1]])
            ckv = ckv_cache[pages].reshape(-1, d_ckv)[:kv_len]
            kpe = kpe_cache[pages][..., :d_kpe].reshape(-1, d_kpe)[:kv_len]
            k_r = torch.cat([ckv, kpe], dim=-1)[:, None, :]
            o, lse = attention_reference(
                q_r, k_r.to(q.dtype), ckv[:, None, :].to(q.dtype),
                causal=self.device_plan.meta.causal,
                sm_scale=self.device_plan.meta.sm_scale)
            outs.append(o)
            lses.append(lse)
        out = torch.cat(outs, 0)
        return (out, torch.cat(lses, 0)) if return_lse else out
