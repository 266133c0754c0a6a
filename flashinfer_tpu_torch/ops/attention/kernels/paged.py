"""Paged attention over a planned work list: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``_paged_kernel`` (flashinfer_tpu/ops/attention/
kernels/paged.py:161, launched by ``batch_paged_attention_run`` :750). The
kernel itself is ``flashinfer_tpu_torch/csrc/paged_attention.cu``; its
source note says what bounds it on the H100 and how its design answers.

Both versions read the same int32 plan (``AttentionPlan.prefetch_arrays``,
12 rows of T work items) and write the same split-KV partials:
``partial_o [T, kvh, tile_q, dv]`` in q's dtype and ``partial_lse
[T, kvh, tile_q]`` f32 in natural log. A padding item (request < 0), an
empty KV range, a padding row (``row_valid`` 0: the plan blob's segment of
that name, which ``out_map`` never reads) and a row that sees no key give
o = 0 and lse = -inf, the identity of the merge. Both versions write that
identity on padding rows, so their outputs agree on every row.

KV caches: the model dtype, ``torch.float8_e4m3fn`` (e4m3; an int8 tensor
holding the JAX package's e4m3 bits is read through
``.view(torch.float8_e4m3fn)``), or int8 as a linear container
(value = q * scale). ``k_scale`` folds into the
softmax scale and ``v_scale`` multiplies the output, as on the TPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.utils import TensorLayout

__all__ = ["batch_paged_attention_run", "paged_attention_plain"]

# rows of the plan that the kernels read (AttentionPlan.prefetch_arrays)
_REQ, _QO_TILE, _QO_START, _KV_START, _KV_END, _KV_PAGE_START, _Q_POS_BASE = (
    0, 1, 3, 5, 6, 7, 9)

# dtype codes of the C entry point (csrc/paged_attention.cu)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_E4M3, _KV_I8 = 2, 3
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _kv_format(k: torch.Tensor) -> str:
    """'model' | 'e4m3' | 'int8', from the cache's dtype."""
    if k.dtype == torch.float8_e4m3fn:
        return "e4m3"
    if k.dtype == torch.int8:
        return "int8"
    return "model"


def paged_attention_plain(
    q_packed: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_indices: torch.Tensor,
    plan: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    causal: bool,
    sm_scale: float,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    window_left: int = -1,
    logits_soft_cap: float = 0.0,
    kv_layout: TensorLayout = TensorLayout.NHD,
    kv_indices_offset: int = 0,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The work list in plain PyTorch, all items at once: each item's KV
    chunk is gathered page by page into [T, kvh, C, d] and attended in one
    softmax pass (the reference's single resident tile, nsub == 1).

    Rounding as on the TPU: K and V are upcast exactly; P goes into the PV
    product in the dtype of the V operand (q's dtype; bf16 for e4m3,
    whose decode the TPU kernel runs in bf16, so q is rounded to bf16 too),
    rounded as 2^(s - ceil(max s)) in the base-2 domain, which the kernel's
    online softmax reproduces exactly."""
    fmt = _kv_format(k_cache)
    kvh, q_rows, d = q_packed.shape
    dev = q_packed.device
    if kv_layout == TensorLayout.HND:
        ps, dv = k_cache.shape[2], v_cache.shape[3]
    else:
        ps, dv = k_cache.shape[1], v_cache.shape[3]
    p = plan.reshape(12, -1).long()
    T = p.shape[1]
    req = p[_REQ]
    kv_start, kv_end = p[_KV_START], p[_KV_END]
    span = torch.where(req >= 0, (kv_end - kv_start).clamp(min=0), 0)
    out_o = torch.zeros(T, kvh, tile_q, dv, dtype=q_packed.dtype, device=dev)
    out_lse = torch.full((T, kvh, tile_q), float("-inf"), device=dev)
    rows = (p[_QO_START][:, None] + torch.arange(tile_q, device=dev)[None, :])
    real = rows < q_rows  # [T, tile_q]
    if row_valid is not None:
        real = real & (row_valid.reshape(-1)[rows.clamp(max=q_rows - 1)] != 0)
    max_span = int(span.max()) if T else 0
    if max_span == 0:
        return out_o, out_lse
    npages = -(-max_span // ps)
    C = npages * ps

    pidx = (p[_KV_PAGE_START][:, None]
            + torch.arange(npages, device=dev)[None, :])
    pidx = pidx.clamp(0, kv_indices.numel() - 1)
    pages = kv_indices.long()[pidx] + kv_indices_offset  # [T, npages]

    def gather(cache):
        g = cache[pages]  # NHD [T, np, ps, kvh, d] / HND [T, np, kvh, ps, d]
        if kv_layout == TensorLayout.HND:
            g = g.permute(0, 2, 1, 3, 4)
        else:
            g = g.permute(0, 3, 1, 2, 4)
        return g.reshape(T, kvh, C, g.shape[-1]).float()

    kf, vf = gather(k_cache), gather(v_cache)

    q = q_packed[:, rows.clamp(max=q_rows - 1)].permute(1, 0, 2, 3)
    pv_dtype = torch.bfloat16 if fmt == "e4m3" else q_packed.dtype
    qf = q.to(pv_dtype).float()  # [T, kvh, tile_q, d]

    # base-2 softmax domain of the kernels: log2(e) rides the scale, or is
    # applied after the soft cap
    s = torch.einsum("thrd,thcd->thrc", qf, kf)
    if logits_soft_cap > 0.0:
        s = s * (sm_scale * k_scale)
        s = logits_soft_cap * torch.tanh(s / logits_soft_cap) * _LOG2E
    else:
        s = s * (sm_scale * k_scale * _LOG2E)
    col = torch.arange(C, device=dev)
    kv_pos = kv_start[:, None] + col[None, :]  # [T, C]
    q_tok = p[_Q_POS_BASE][:, None] + (
        p[_QO_TILE][:, None] * tile_q
        + torch.arange(tile_q, device=dev)[None, :]) // group  # [T, tile_q]
    mask = (col[None, :] < span[:, None])[:, None, :]  # [T, 1, C]
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_tok[:, :, None])
    if window_left >= 0:
        mask = mask & (kv_pos[:, None, :] > q_tok[:, :, None] - window_left - 1)
    mask = mask[:, None]  # [T, 1, tile_q | 1, C]
    s2 = torch.where(mask, s, float("-inf"))
    # the ceiling of the base-2 max, as the kernel takes it (an integer,
    # so its online rescales are exact powers of two)
    m = s2.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, torch.ceil(m))
    pr = torch.where(mask, torch.exp2(s2 - m_safe), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    pv = torch.einsum("thrc,thcd->thrd", pr.to(pv_dtype).float(), vf)
    safe_l = torch.where(l > 0, l, 1.0)
    o = pv / safe_l * v_scale
    lse = torch.where(l > 0, m_safe * _LN2 + torch.log(safe_l), float("-inf"))
    real = real[:, None, :]  # [T, 1, tile_q]: padding rows get the identity
    o = torch.where(real[..., None], o, 0.0)
    lse = torch.where(real, lse[..., 0], float("-inf"))
    return o.to(q_packed.dtype), lse


def _lib():
    lib = jit.load("paged_attention")
    fn = lib.fi_paged_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, P,  # q k v plan idx valid o lse
                       # T kvh rows tq d dv ps pages hnd off grp
                       I, I, I, I, I, I, I, I, I, I, I,
                       # scales causal window cap dtypes stream
                       F, F, I, I, F, I, I, P]
        fn.restype = I
    return fn


def batch_paged_attention_run(
    q_packed: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_indices: torch.Tensor,
    plan: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    causal: bool,
    sm_scale: float,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    window_left: int = -1,
    logits_soft_cap: float = 0.0,
    kv_layout: TensorLayout = TensorLayout.NHD,
    kv_indices_offset: int = 0,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the planned work list. q_packed [kvh, rows, d] (GQA-packed, per
    request tile_q-aligned); k caches NHD [P, ps, kvh, d] or HND
    [P, kvh, ps, d], v caches the same with dv columns; kv_indices int32
    page table; plan int32 [12 * T]; row_valid int32 [rows] or None (every
    row real): a 64-row block of padding rows is skipped.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``paged_attention_plain``. bf16 numerics (bf16 q, or an e4m3 cache) run
    on the tensor cores and need pages of a multiple of 8 tokens; f32 q
    with an f32 or int8 cache runs on the CUDA cores."""
    kw = dict(tile_q=tile_q, group=group, causal=causal, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale, window_left=window_left,
              logits_soft_cap=logits_soft_cap, kv_layout=kv_layout,
              kv_indices_offset=kv_indices_offset, row_valid=row_valid)
    if not q_packed.is_cuda:
        return paged_attention_plain(q_packed, k_cache, v_cache, kv_indices,
                                     plan, **kw)
    fmt = _kv_format(k_cache)
    kvh, q_rows, d = q_packed.shape
    if q_packed.dtype not in _Q_CODES:
        raise TypeError(f"paged kernel takes bf16/f32 q, got {q_packed.dtype}")
    if fmt == "model" and k_cache.dtype != q_packed.dtype:
        raise TypeError(f"cache {k_cache.dtype} does not match q "
                        f"{q_packed.dtype}")
    hnd = kv_layout == TensorLayout.HND
    ps = k_cache.shape[2] if hnd else k_cache.shape[1]
    dv = v_cache.shape[3]
    if (v_cache.dtype != k_cache.dtype or k_cache.dim() != 4
            or v_cache.shape[:3] != k_cache.shape[:3]):
        raise ValueError("k and v caches differ in dtype, or in shape "
                         "outside the last (head) dimension")
    if (d > 256 or d % 16 or dv > 256 or dv % 16 or tile_q <= 0
            or tile_q % 8):
        raise ValueError(f"paged kernel takes head_dim and v head_dim <= "
                         f"256 (multiples of 16) and tile_q a multiple of "
                         f"8; got d={d}, dv={dv}, tile_q={tile_q}")
    if k_cache.shape[1 if hnd else 2] != kvh or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"[{kvh}, *, {d}] in layout {kv_layout.name}")
    tensor_cores = q_packed.dtype == torch.bfloat16 or fmt == "e4m3"
    if tensor_cores and (ps % 8 or k_cache.data_ptr() % 16
                         or v_cache.data_ptr() % 16):
        raise ValueError(f"the tensor-core paged kernel takes pages of a "
                         f"multiple of 8 tokens in 16-byte-aligned caches; "
                         f"got page_size={ps}")
    for t, name in ((k_cache, "k"), (v_cache, "v"), (kv_indices, "kv_indices"),
                    (plan, "plan")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if kv_indices.dtype != torch.int32 or plan.dtype != torch.int32:
        raise TypeError("plan and kv_indices must be int32")
    if row_valid is not None:
        if (row_valid.dtype != torch.int32 or not row_valid.is_cuda
                or not row_valid.is_contiguous()
                or row_valid.numel() < q_rows):
            raise ValueError(f"row_valid must be a contiguous int32 CUDA "
                             f"tensor of {q_rows} rows")
    T = plan.numel() // 12
    q_packed = q_packed.contiguous()
    o = torch.empty(T, kvh, tile_q, dv, dtype=q_packed.dtype,
                    device=q_packed.device)
    lse = torch.empty(T, kvh, tile_q, dtype=torch.float32,
                      device=q_packed.device)
    kv_code = {"model": _Q_CODES[q_packed.dtype], "e4m3": _KV_E4M3,
               "int8": _KV_I8}[fmt]
    err = _lib()(
        q_packed.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        plan.data_ptr(), kv_indices.data_ptr(),
        None if row_valid is None else row_valid.data_ptr(), o.data_ptr(),
        lse.data_ptr(), T, kvh, q_rows, tile_q, d, dv, ps, k_cache.shape[0],
        int(hnd), int(kv_indices_offset), group, float(sm_scale * k_scale),
        float(v_scale), int(causal), int(window_left), float(logits_soft_cap),
        _Q_CODES[q_packed.dtype], kv_code,
        torch.cuda.current_stream(q_packed.device).cuda_stream)
    jit.check(err, "paged attention kernel")
    batch_paged_attention_run.launches += 1
    return o, lse


batch_paged_attention_run.launches = 0
