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

Masks and variants, as the TPU kernel takes them: ``work_mask`` is the
plan's legalised custom or multi-item mask (uint8 [T, tile_q,
kv_chunk_size], a column per key of the item's chunk), ANDed with causal
and window. A variant's logit transform sees the logits after the scale
and before the soft cap; ALiBi (``variant_params["alibi_slopes"]``, f32
[num_qo_heads]) adds ``slope[head] * (kv_pos - q_pos)`` there. A packed
row's query head is ``kv_head * group + (qo_tile * tile_q + row) % group``,
its true head in its request (the TPU kernel takes ``row % group`` of the
row in its tile, which agrees only where tile_q is a multiple of the
group).

A work mask's tile map (``kernels/tile_map.py``: uint8 [T, ceil(tile_q /
64), ceil(chunk / 64)], ``paged_tile_map``; the plan builds the same on the
host) classes each (item, 64-row block, 64-key tile). The kernel skips the
key tiles a CTA's rows keep nothing of and runs the tiles the mask keeps
whole without reading it; the plain version, given the map, drops and
keeps the same (so a map that misclassed a tile would show).
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.jit.variant import (
    CompiledVariant,
    UserParamsC,
    compile_variant,
    needs_jit,
)
from flashinfer_tpu_torch.ops.attention.kernels.tile_map import (
    MAP_TILE,
    map_classes,
    mapped_keep,
    tile_classes,
)
from flashinfer_tpu_torch.ops.attention.variants import AttentionVariant
from flashinfer_tpu_torch.utils import TensorLayout

__all__ = ["batch_paged_attention_run", "paged_attention_plain",
           "paged_tile_map"]

# rows of the plan that the kernels read (AttentionPlan.prefetch_arrays)
_REQ, _QO_TILE, _QO_START, _KV_START, _KV_END, _KV_PAGE_START, _Q_POS_BASE = (
    0, 1, 3, 5, 6, 7, 9)

# dtype codes of the C entry point (csrc/paged_attention.cu)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_E4M3, _KV_I8 = 2, 3
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
NON_SOFTMAX = "non-softmax variants: use the dense kernel"


def paged_tile_map(plan: torch.Tensor, work_mask: torch.Tensor, *,
                   tile_q: int, group: int, causal: bool,
                   window_left: int = -1, q_rows: int,
                   row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A work mask's tile map on its own device, in plain torch (no host
    sync): uint8 [T, ceil(tile_q / 64), ceil(chunk / 64)]. The plan builds
    it on the host beside the work mask; the wrapper, handed a work mask
    alone, on the mask's device. A row is real as the kernel's ``row_ok``
    says (inside the q rows and, with ``row_valid``, marked valid); a key
    is in reach inside the item's span and under causal and the window."""
    p = plan.reshape(12, -1).long()
    T, chunk = p.shape[1], work_mask.shape[2]
    dev = work_mask.device
    if tuple(work_mask.shape[:2]) != (T, tile_q):
        raise ValueError(f"work_mask {tuple(work_mask.shape)} is not "
                         f"[{T}, {tile_q}, chunk]")
    span = torch.where(p[_REQ] >= 0,
                       (p[_KV_END] - p[_KV_START]).clamp(min=0), 0)
    r = torch.arange(tile_q, device=dev)
    rows = p[_QO_START][:, None] + r[None, :]  # [T, tile_q]
    real = rows < q_rows
    if row_valid is not None:
        real = real & (row_valid.reshape(-1)[rows.clamp(0, q_rows - 1)] != 0)
    tok = (p[_Q_POS_BASE][:, None]
           + (p[_QO_TILE][:, None] * tile_q + r[None, :]) // group)
    col = torch.arange(chunk, device=dev)
    pos = p[_KV_START][:, None] + col[None, :]  # [T, chunk]
    reach = real[:, :, None] & (col[None, :] < span[:, None])[:, None, :]
    if causal:
        reach = reach & (pos[:, None, :] <= tok[:, :, None])
    if window_left >= 0:
        reach = reach & (pos[:, None, :] >= tok[:, :, None] - window_left)
    return map_classes(reach, work_mask != 0)


def _mapped_mask(work_mask: Optional[torch.Tensor], tile_map: torch.Tensor,
                 tile_q: int, C: int) -> torch.Tensor:
    """bool [T, tile_q, C]: the work mask as the kernel reads it under the
    tile map."""
    T, dev = tile_map.shape[0], tile_map.device
    wm = torch.ones(T, tile_q, C, dtype=torch.bool, device=dev)
    if work_mask is not None:
        n = min(C, work_mask.shape[2])
        wm[:, :, :n] = work_mask[:, :, :n] != 0
    return mapped_keep(wm, tile_classes(
        tile_map, torch.arange(tile_q, device=dev),
        torch.arange(C, device=dev)))


def _kv_format(k: torch.Tensor) -> str:
    """'model' | 'e4m3' | 'int8', from the cache's dtype."""
    if k.dtype == torch.float8_e4m3fn:
        return "e4m3"
    if k.dtype == torch.int8:
        return "int8"
    return "model"


def _resolve_variant(variant: Optional[AttentionVariant], variant_params,
                     logits_soft_cap: float):
    """(soft cap, ALiBi slopes or None, hooks or None). A built-in variant
    becomes the numbers the kernel reads; a variant with hooks of the
    caller's own is returned as ``hooks`` (the plain version runs them, the
    kernel its build for them). The output transform is not applied, as in
    the TPU kernel."""
    if variant is None:
        return float(logits_soft_cap), None, None
    if not variant.use_softmax:
        raise ValueError(NON_SOFTMAX)
    spec = variant.kernel
    if needs_jit(variant, "paged"):
        return 0.0, None, variant
    alibi = variant_params["alibi_slopes"] if spec.use_alibi else None
    return float(spec.logits_soft_cap), alibi, None


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
    work_mask: Optional[torch.Tensor] = None,
    variant: Optional[AttentionVariant] = None,
    variant_params: Any = None,
    tile_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The work list in plain PyTorch, all items at once: each item's KV
    chunk is gathered page by page into [T, kvh, C, d] and attended in one
    softmax pass (the reference's single resident tile, nsub == 1).

    Rounding as on the TPU: K and V are upcast exactly; P goes into the PV
    product in the dtype of the V operand (q's dtype; bf16 for e4m3,
    whose decode the TPU kernel runs in bf16, so q is rounded to bf16 too),
    rounded as 2^(s - ceil(max s)) in the base-2 domain, which the kernel's
    online softmax reproduces exactly. ``variant``'s hooks (query and logit
    transforms, logit mask) see the positions the kernel gives them: keys
    past an item's span take its last key's, rows past its last real row
    that row's token (only masked or dropped values change), so a table a
    hook reads at ``q_pos`` / ``kv_pos`` is read at real positions.
    ``tile_map`` (a work mask's) drops the keys of the tiles it says keep
    nothing and keeps every key of those it says the mask keeps whole, as
    the kernel does."""
    cap, alibi, hooks = _resolve_variant(variant, variant_params,
                                         logits_soft_cap)
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
    qf = q.float()  # [T, kvh, tile_q, d]
    if hooks is not None and hooks.query_transform is not None:
        qf = hooks.query_transform(variant_params, qf)
    qf = qf.to(pv_dtype).float()

    col = torch.arange(C, device=dev)
    kv_pos = (kv_start[:, None] + col[None, :])[:, None, None, :]  # [T,1,1,C]
    local = (p[_QO_TILE][:, None] * tile_q
             + torch.arange(tile_q, device=dev)[None, :])  # [T, tile_q]
    q_tok = (p[_Q_POS_BASE][:, None] + local // group)[:, None, :, None]
    head = (torch.arange(kvh, device=dev)[None, :, None] * group
            + (local % group)[:, None, :])[..., None]  # [T, kvh, tile_q, 1]
    transform = hooks is not None and hooks.logits_transform is not None
    if hooks is not None:
        kv_hook = torch.minimum(
            kv_pos, (kv_start + span - 1)[:, None, None, None])
        tok2 = q_tok[:, 0, :, 0]  # [T, tile_q]
        tok_hi = torch.where(real, tok2, tok2.min()).amax(dim=1)
        q_hook = torch.minimum(q_tok, tok_hi[:, None, None, None])

    # base-2 softmax domain of the kernels: log2(e) rides the scale, or is
    # applied after the transforms (ALiBi, the caller's, the soft cap)
    s = torch.einsum("thrd,thcd->thrc", qf, kf)
    if cap > 0.0 or alibi is not None or transform:
        s = s * (sm_scale * k_scale)
        if alibi is not None:
            s = s + alibi.to(dev).float()[head] * (kv_pos - q_tok).float()
        if transform:
            s = hooks.logits_transform(variant_params, s, q_hook, kv_hook,
                                       head)
        if cap > 0.0:
            s = cap * torch.tanh(s / cap)
        s = s * _LOG2E
    else:
        s = s * (sm_scale * k_scale * _LOG2E)
    mask = (col[None, :] < span[:, None])[:, None, None, :]  # [T, 1, 1, C]
    if causal:
        mask = mask & (kv_pos <= q_tok)
    if window_left >= 0:
        mask = mask & (kv_pos > q_tok - window_left - 1)
    if tile_map is not None:
        mask = mask & _mapped_mask(work_mask, tile_map, tile_q, C)[:, None]
    elif work_mask is not None:
        mask = mask & (work_mask[:, None, :, :C] != 0)
    if hooks is not None and hooks.logits_mask is not None:
        mask = mask & hooks.logits_mask(variant_params, q_hook, kv_hook,
                                        head)
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


def _lib(user: Optional[CompiledVariant] = None, gather: bool = False):
    """The kernel's C entry: of the TMA build, or with ``gather`` of the
    build that gathers pages of any size (``csrc/paged_attention_gather.cu``);
    with a caller's variant, that of its own build (``jit.variant``), which
    takes a ``UserParams`` last."""
    name = "paged_attention_gather" if gather else "paged_attention"
    lib = (jit.load(name) if user is None else
           jit.load(name, user.header_path()))
    fn = lib.fi_paged_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P,  # q k v plan idx valid
                       P, P, P, ctypes.c_longlong,  # work_mask map walks
                       P, P, P,  # alibi o lse
                       # T kvh rows tq d dv ps pages hnd off grp chunk
                       I, I, I, I, I, I, I, I, I, I, I, I,
                       # scales causal window cap dtypes stream
                       F, F, I, I, F, I, I, P]
        if user is not None:
            fn.argtypes.append(ctypes.POINTER(UserParamsC))
        fn.restype = I
    return fn


def _device_arg(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
                numel: int) -> Optional[torch.Tensor]:
    """t as a contiguous CUDA tensor of ``dtype`` with at least ``numel``
    elements, or raise."""
    if t is None:
        return None
    if (t.dtype != dtype or not t.is_cuda or not t.is_contiguous()
            or t.numel() < numel):
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor "
                         f"of {numel} elements; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t


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
    work_mask: Optional[torch.Tensor] = None,
    variant: Optional[AttentionVariant] = None,
    variant_params: Any = None,
    tile_map: Any = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the planned work list. q_packed [kvh, rows, d] (GQA-packed, per
    request tile_q-aligned); k caches NHD [P, ps, kvh, d] or HND
    [P, kvh, ps, d], v caches the same with dv columns; kv_indices int32
    page table; plan int32 [12 * T]; row_valid int32 [rows] or None (every
    row real): a 64-row block of padding rows is skipped. ``work_mask``
    uint8 [T, tile_q, chunk] or None; ``variant`` (with ``variant_params``:
    ALiBi's f32 [kvh * group] "alibi_slopes") replaces ``logits_soft_cap``
    where given. ``tile_map``: the work mask's map (the plan's
    ``DevicePlan.tile_map``); None derives it on the mask's device
    (``paged_tile_map``); False runs without one (every tile of a masked
    plan tested key by key: the kernels' path before the map). ``out``:
    CUDA tensors (o, lse) of the partials' shapes and dtypes to write them
    into and return, in place of new ones (``run_device_plan``'s
    ``PartialsWorkspace``).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``paged_attention_plain``. bf16 numerics (bf16 q, or an e4m3 cache) run
    on the tensor cores, at any page size: pages of a multiple of 8 tokens
    arrive by TMA, others in the kernel's gather build, by cp.async (the
    wrappers repack pages under 8 tokens, as JAX's do); f32 q with an f32
    or int8 cache runs on the CUDA cores. ``launches`` counts every
    launch, ``gather_launches`` those of the gather build. A variant with hooks of the caller's own runs in the
    kernel's build for that variant (``jit.variant``; a hook outside the
    traced subset raises ``NotImplementedError`` before any build); a
    non-softmax variant runs in neither version."""
    if work_mask is not None and work_mask.dtype in (torch.int8, torch.bool):
        work_mask = work_mask.view(torch.uint8)
    if tile_map is None and work_mask is not None:
        tile_map = paged_tile_map(
            plan, work_mask, tile_q=tile_q, group=group, causal=causal,
            window_left=window_left, q_rows=q_packed.shape[1],
            row_valid=row_valid)
    if tile_map is False or work_mask is None:
        tile_map = None
    if tile_map is not None:
        want = (plan.numel() // 12, -(-tile_q // MAP_TILE),
                -(-work_mask.shape[2] // MAP_TILE))
        if tuple(tile_map.shape) != want or tile_map.dtype != torch.uint8:
            raise ValueError(f"tile_map {tile_map.dtype} "
                             f"{tuple(tile_map.shape)} does not cover the "
                             f"plan's uint8 {list(want)} tiles")
    kw = dict(tile_q=tile_q, group=group, causal=causal, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale, window_left=window_left,
              logits_soft_cap=logits_soft_cap, kv_layout=kv_layout,
              kv_indices_offset=kv_indices_offset, row_valid=row_valid,
              work_mask=work_mask, variant=variant,
              variant_params=variant_params, tile_map=tile_map)
    cap, alibi, hooks = _resolve_variant(variant, variant_params,
                                         logits_soft_cap)
    if not q_packed.is_cuda:
        if out is not None:
            raise ValueError("out takes CUDA tensors: the plain version "
                             "returns new ones")
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
    if tensor_cores and (k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError("the tensor-core paged kernel takes 16-byte-aligned "
                         "caches")
    for t, name in ((k_cache, "k"), (v_cache, "v"), (kv_indices, "kv_indices"),
                    (plan, "plan")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if kv_indices.dtype != torch.int32 or plan.dtype != torch.int32:
        raise TypeError("plan and kv_indices must be int32")
    T = plan.numel() // 12
    row_valid = _device_arg(row_valid, "row_valid", torch.int32, q_rows)
    chunk = 0
    if work_mask is not None:
        if work_mask.dim() != 3 or tuple(work_mask.shape[:2]) != (T, tile_q):
            raise ValueError(f"work_mask {tuple(work_mask.shape)} is not "
                             f"[{T}, {tile_q}, chunk]")
        chunk = work_mask.shape[2]
        work_mask = _device_arg(work_mask, "work_mask", torch.uint8, 0)
    walks = None
    if tile_map is not None:
        tile_map = _device_arg(tile_map, "tile_map", torch.uint8, 0)
        # the kernel's scratch for its CTAs' walks of the map: a count and a
        # list of up to map_nt tiles a CTA (an item's 64-row blocks bound
        # its CTAs)
        walks = torch.empty(T * tile_map.shape[1] * (1 + tile_map.shape[2]),
                            dtype=torch.int32, device=q_packed.device)
    if alibi is not None:
        alibi = _device_arg(alibi.reshape(-1), "alibi_slopes", torch.float32,
                            kvh * group)
    q_packed = q_packed.contiguous()
    if out is None:
        o = torch.empty(T, kvh, tile_q, dv, dtype=q_packed.dtype,
                        device=q_packed.device)
        lse = torch.empty(T, kvh, tile_q, dtype=torch.float32,
                          device=q_packed.device)
    else:
        o, lse = out
        if (tuple(o.shape) != (T, kvh, tile_q, dv)
                or o.dtype != q_packed.dtype
                or tuple(lse.shape) != (T, kvh, tile_q)
                or lse.dtype != torch.float32):
            raise ValueError(
                f"out {o.dtype} {tuple(o.shape)}, {lse.dtype} "
                f"{tuple(lse.shape)} is not the partials' {q_packed.dtype} "
                f"[{T}, {kvh}, {tile_q}, {dv}] and f32 [{T}, {kvh}, "
                f"{tile_q}]")
        for t in (o, lse):
            _device_arg(t, "out", t.dtype, t.numel())
    kv_code = {"model": _Q_CODES[q_packed.dtype], "e4m3": _KV_E4M3,
               "int8": _KV_I8}[fmt]
    user = (None if hooks is None else
            compile_variant(hooks, variant_params, "paged", kvh * group))
    gather = tensor_cores and ps % 8 != 0
    fn = _lib(user, gather)
    extra = ()
    if user is not None:  # the leaves, alive until the launch is enqueued
        up, leaves = user.user_params(variant_params, q_packed.device)
        extra = (ctypes.byref(up),)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(
        q_packed.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        plan.data_ptr(), kv_indices.data_ptr(), ptr(row_valid),
        ptr(work_mask), ptr(tile_map), ptr(walks),
        0 if walks is None else walks.numel(), ptr(alibi), o.data_ptr(),
        lse.data_ptr(), T, kvh,
        q_rows, tile_q, d, dv, ps, k_cache.shape[0], int(hnd),
        int(kv_indices_offset), group, chunk, float(sm_scale * k_scale),
        float(v_scale), int(causal), int(window_left), cap,
        _Q_CODES[q_packed.dtype], kv_code,
        torch.cuda.current_stream(q_packed.device).cuda_stream, *extra)
    jit.check(err, "paged attention kernel")
    batch_paged_attention_run.launches += 1
    batch_paged_attention_run.gather_launches += gather
    return o, lse


batch_paged_attention_run.launches = 0
batch_paged_attention_run.gather_launches = 0
