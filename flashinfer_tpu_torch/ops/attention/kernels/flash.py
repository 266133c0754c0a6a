"""Dense single-request attention: the CUDA flash kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``_flash_kernel`` (flashinfer_tpu/ops/attention/
kernels/flash.py:93, launched by ``flash_attention_dense`` :255). The kernel
itself is ``flashinfer_tpu_torch/csrc/flash_attention.cu``; its source note
says what bounds it on the H100 and how its design answers.

Both versions compute what the TPU kernel computes: logits ``q.k * sm_scale``
with f32 accumulation; the variant's logits transform (ALiBi, then the soft
cap; or the sigmoid); the mask (``kv_pos < kv_len``, causal with query i at
position ``kv_len - qo_len + i``, the window ``kv_pos >= q_pos -
window_left``, the custom mask); softmax with P rounded to v's dtype before
P.V; the sink added once at the end. A row that sees no key gives o = 0 and
lse = -inf (o and lse 0 for the sigmoid). lse is natural-log.

``custom_mask`` is either bool [qo_len, kv_len] (True = keep) or the JAX
package's packed form, uint8 bits in "big" order over the flattened
[qo_len, kv_len] matrix; the tensor's dtype decides. The kernel reads the
packed bits (8x fewer bytes); a bool mask is packed on the device first.

A mask (the custom mask, a caller's mask hook, or both) reaches the kernel
with its tile map (``kernels/tile_map.py``: [map heads, 64-row blocks of
packed rows, 64-key tiles]), written by a first launch of the same library
(``flash_tile_map``); the kernel then skips the key tiles a CTA's rows keep
nothing of and runs the tiles the mask keeps whole without it. The map has
a head per kv head where the hook reads the head, else one.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    DefaultAttention,
    KernelVariant,
)
from flashinfer_tpu_torch.ops.quantization import packbits, unpackbits
from flashinfer_tpu_torch.utils import cdiv

__all__ = ["flash_attention_dense", "flash_attention_plain",
           "flash_num_splits", "flash_tile_map", "flash_tile_map_plain"]

_NEG_INF = float("-inf")
# the kernel's tiles (csrc/flash_attention.cu): packed q rows a CTA; bf16
# runs on wgmma (two warpgroups of 64 rows, one CTA an SM), f32 on the CUDA
# cores (16 rows, 64-key tiles, two CTAs an SM)
_ROWS = {torch.bfloat16: 128, torch.float32: 16}
_CTAS_PER_SM = {torch.bfloat16: 1, torch.float32: 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_DV = (64, 128, 192, 256)
_MIN_TILES_PER_SPLIT = 4
_SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use (H100)


def _tile_k(dtype: torch.dtype, d: int, dv: int) -> int:
    """Keys a tile (``tc_tile_k`` in the kernel): 128 for bf16 where S and
    O fit the registers (dv <= 128) and Q, two K/V stages, their barriers
    and the alignment slack fit the shared memory, else 64."""
    if dtype != torch.bfloat16:
        return 64
    blocks = cdiv(d, 64)
    smem = (1024 + 2 * blocks * 64 * 128
            + 2 * (blocks + dv // 64) * 128 * 128 + 64)
    return 128 if dv <= 128 and smem <= _SMEM_LIMIT else 64


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_mask_bits(custom_mask: torch.Tensor, qo_len: int, kv_len: int):
    if custom_mask.numel() * (8 if custom_mask.dtype == torch.uint8 else 1) \
            < qo_len * kv_len:
        raise ValueError(f"custom mask of {custom_mask.numel()} "
                         f"{custom_mask.dtype} entries does not cover "
                         f"[{qo_len}, {kv_len}]")


def _dense_mask(custom_mask: torch.Tensor, qo_len: int,
                kv_len: int) -> torch.Tensor:
    _check_mask_bits(custom_mask, qo_len, kv_len)
    if custom_mask.dtype == torch.uint8:
        return unpackbits(custom_mask, qo_len * kv_len).reshape(qo_len,
                                                                kv_len)
    return custom_mask.bool().reshape(qo_len, kv_len)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    window_left: int = -1,
    custom_mask: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    variant: AttentionVariant = DefaultAttention,
    variant_params: Any = None,
    tile_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one kv head's query group at
    a time (so that long sequences fit), every hook applied. Softmax runs
    against each row's global maximum; the kernel's against a running one.
    Hooks see absolute head indices, as in ``attention_reference``. The
    sink comes from ``sink`` alone, as in the TPU kernel: a variant's
    ``sink_logits`` hook is the oracle's. ``tile_map`` (the mask's, as
    ``flash_tile_map`` builds it) drops the keys of the tiles it says keep
    nothing and unmasks the tiles it says the mask keeps whole, as the
    kernel does."""
    qo_len, hq, d = q.shape
    kv_len, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    dev = q.device
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    q_pos = torch.arange(qo_len, device=dev)[:, None] + (kv_len - qo_len)
    kv_pos = torch.arange(kv_len, device=dev)[None, :]
    reach = _reach(q_pos, kv_pos, kv_len, causal, window_left)
    dense = (None if custom_mask is None
             else _dense_mask(custom_mask, qo_len, kv_len))
    mask = reach if dense is None else reach & dense

    qf = q.float()
    if variant.query_transform is not None:  # rounded as the kernel feeds q
        qf = variant.query_transform(variant_params, qf).to(q.dtype).float()
    out = torch.empty(qo_len, hq, dv, dtype=torch.float32, device=dev)
    lse = torch.zeros(qo_len, hq, device=dev)
    for h in range(hkv):
        hs = slice(h * group, (h + 1) * group)
        head_idx = torch.arange(h * group, (h + 1) * group,
                                device=dev)[:, None, None]
        s = torch.einsum("qgd,kd->gqk", qf[:, hs], k[:, h].float()) * sm_scale
        if variant.logits_transform is not None:
            s = variant.logits_transform(variant_params, s, q_pos, kv_pos,
                                         head_idx)
        hook = (None if variant.logits_mask is None else
                variant.logits_mask(variant_params, q_pos, kv_pos, head_idx))
        if tile_map is None:
            keep = mask[None] if hook is None else mask[None] & hook
        else:  # the mask as the kernel reads it under its map
            m = torch.ones(group, qo_len, kv_len, dtype=torch.bool,
                           device=dev)
            for part in (dense, hook):
                if part is not None:
                    m = m & part
            rows = (torch.arange(qo_len, device=dev)[None, :] * group
                    + torch.arange(group, device=dev)[:, None])
            hm = h if tile_map.shape[0] > 1 else 0
            cls = tile_classes(tile_map[hm:hm + 1], rows.reshape(-1),
                               torch.arange(kv_len, device=dev))
            keep = reach[None] & mapped_keep(
                m, cls.reshape(group, qo_len, kv_len))
        vf = v[:, h].float()
        if not variant.use_softmax:
            w = torch.where(keep, s, 0.0).to(v.dtype).float()
            out[:, hs] = torch.einsum("gqk,kd->qgd", w, vf)
            continue
        s = torch.where(keep, s, _NEG_INF)
        m = s.amax(dim=-1)  # [g, q]
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.where(keep, torch.exp(s - m_safe[..., None]), 0.0)
        l = p.sum(dim=-1)
        o = torch.einsum("gqk,kd->gqd", p.to(v.dtype).float(), vf)
        if sink is not None:
            sk = sink[hs].float()[:, None].to(dev)  # [g, 1]
            m_fin = torch.maximum(m, sk)
            m_fin_safe = torch.where(torch.isneginf(m_fin), 0.0, m_fin)
            scale = torch.where(torch.isneginf(m), 0.0,
                                torch.exp(m - m_fin_safe))
            l = l * scale + torch.exp(sk - m_fin_safe)
            o = o * scale[..., None]
            m, m_safe = m_fin, m_fin_safe
        safe_l = torch.where(l > 0, l, 1.0)
        out[:, hs] = (o / safe_l[..., None]).transpose(0, 1)
        lse[:, hs] = torch.where(l > 0, m_safe + torch.log(safe_l),
                                 _NEG_INF).T
    if variant.output_transform is not None:
        out = variant.output_transform(variant_params, out)
    return out.to(q.dtype), lse


def _reach(q_pos, kv_pos, kv_len: int, causal: bool,
           window_left: int) -> torch.Tensor:
    """bool [qo, kv]: the pairs a row may see at all (a real key, causal,
    the window)."""
    mask = (kv_pos < kv_len).expand(q_pos.shape[0], kv_pos.shape[1])
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window_left >= 0:
        mask = mask & (kv_pos > q_pos - window_left - 1)
    return mask


def flash_tile_map_plain(qo_len: int, kv_len: int, num_qo_heads: int,
                         num_kv_heads: int, *, causal: bool = False,
                         window_left: int = -1,
                         custom_mask: Optional[torch.Tensor] = None,
                         variant: AttentionVariant = DefaultAttention,
                         variant_params: Any = None, map_heads: int = 1,
                         device=None) -> torch.Tensor:
    """The tile map of a mask (``custom_mask``, ``variant.logits_mask`` or
    both) in plain torch: uint8 [map_heads, ceil(qo_len * group / 64),
    ceil(kv_len / 64)] over packed rows (token * group + head in group).
    With ``map_heads`` 1 the hook is asked at head 0 for every row (a hook
    that does not read the head), else at each row's head of kv head h."""
    group = num_qo_heads // num_kv_heads
    if custom_mask is not None:
        device = custom_mask.device
    dev = torch.device(device or "cpu")
    q_pos = torch.arange(qo_len, device=dev)[:, None] + (kv_len - qo_len)
    kv_pos = torch.arange(kv_len, device=dev)[None, :]
    keep = torch.ones(qo_len, kv_len, dtype=torch.bool, device=dev)
    if custom_mask is not None:
        keep = keep & _dense_mask(custom_mask.to(dev), qo_len, kv_len)
    rows = torch.arange(qo_len * group, device=dev)
    tok = rows // group
    reach = _reach(q_pos, kv_pos, kv_len, causal, window_left)[tok]
    maps = []
    for hm in range(map_heads):
        k = keep[tok]
        if variant.logits_mask is not None:
            head = ((hm * group + rows % group) if map_heads > 1
                    else torch.zeros_like(rows))
            k = k & variant.logits_mask(variant_params, q_pos[tok], kv_pos,
                                        head[:, None])
        maps.append(map_classes(reach[None], k[None])[0])
    return torch.stack(maps)


def _map_lib(user: Optional[CompiledVariant] = None):
    """The tile map's C entry, of the library the attention runs in."""
    fn = (jit.load("flash_attention") if user is None else
          jit.load("flash_attention", user.header_path())).fi_flash_tile_map
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        # mask map qo kv hq hkv causal window map_heads stream
        fn.argtypes = [P, P, I, I, I, I, I, I, I, P]
        if user is not None:
            fn.argtypes.append(ctypes.POINTER(UserParamsC))
        fn.restype = I
    return fn


def _map_launch(user: Optional[CompiledVariant], bits: Optional[torch.Tensor],
                qo_len: int, kv_len: int, hq: int, hkv: int, causal: bool,
                window_left: int, variant_params: Any,
                dev: torch.device) -> torch.Tensor:
    """The mask's tile map by the kernel's first launch (packed bits
    ``bits`` and/or the user build's hook), or raise."""
    heads = hkv if user is not None and user.mask_reads_head else 1
    tile_map = torch.empty(heads, cdiv(qo_len * (hq // hkv), MAP_TILE),
                           cdiv(kv_len, MAP_TILE), dtype=torch.uint8,
                           device=dev)
    extra = ()
    if user is not None:
        up, leaves = user.user_params(variant_params, dev)
        extra = (ctypes.byref(up),)
    err = _map_lib(user)(
        None if bits is None else bits.data_ptr(), tile_map.data_ptr(),
        qo_len, kv_len, hq, hkv, int(causal), int(window_left), heads,
        torch.cuda.current_stream(dev).cuda_stream, *extra)
    jit.check(err, "flash attention tile map")
    flash_attention_dense.map_launches += 1
    return tile_map


def _has_mask(custom_mask, variant) -> bool:
    return custom_mask is not None or variant.logits_mask is not None


def flash_tile_map(qo_len: int, kv_len: int, num_qo_heads: int,
                   num_kv_heads: int, *, causal: bool = False,
                   window_left: int = -1,
                   custom_mask: Optional[torch.Tensor] = None,
                   variant: AttentionVariant = DefaultAttention,
                   variant_params: Any = None,
                   device="cuda") -> torch.Tensor:
    """The tile map ``flash_attention_dense`` builds for this mask: on a CUDA
    device by the kernel's first launch (counted in
    ``flash_attention_dense.map_launches``), else ``flash_tile_map_plain``
    (a head each kv head where a mask hook is given, the hook untraced).
    ``custom_mask`` as ``flash_attention_dense`` takes it."""
    dev = torch.device(device)
    if not _has_mask(custom_mask, variant) or kv_len <= 0 or qo_len <= 0:
        raise ValueError("a tile map needs a mask and keys")
    if dev.type != "cuda":
        return flash_tile_map_plain(
            qo_len, kv_len, num_qo_heads, num_kv_heads, causal=causal,
            window_left=window_left, custom_mask=custom_mask,
            variant=variant, variant_params=variant_params,
            map_heads=(num_kv_heads if variant.logits_mask is not None
                       else 1), device=dev)
    user = (compile_variant(variant, variant_params, "flash", num_qo_heads)
            if needs_jit(variant, "flash") else None)
    return _map_launch(user, _packed_bits(custom_mask, qo_len, kv_len, dev),
                       qo_len, kv_len, num_qo_heads, num_kv_heads, causal,
                       window_left, variant_params, dev)


def _packed_bits(custom_mask, qo_len: int, kv_len: int,
                 dev: torch.device) -> Optional[torch.Tensor]:
    """The custom mask as the kernel reads it: packed bits on ``dev``."""
    if custom_mask is None:
        return None
    _check_mask_bits(custom_mask, qo_len, kv_len)
    return (custom_mask if custom_mask.dtype == torch.uint8
            else packbits(custom_mask.to(dev))).to(dev).contiguous()


def _lib(user: Optional[CompiledVariant] = None):
    """The kernel's C entry; with a caller's variant, that of its own build
    (``jit.variant``), which takes a ``UserParams`` last."""
    fn = (jit.load("flash_attention") if user is None else
          jit.load("flash_attention", user.header_path())).fi_flash_attention
    if fn.argtypes is None:
        P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        fn.argtypes = [P, P, P, P, P, I,  # q k v mask tile_map map_heads
                       P, L,  # the walks' scratch and its length
                       P, P, P, P,  # alibi sink o lse
                       P, P,  # split partials: o, lse
                       L, L, L, L, L, L,  # q, k, v strides (token, head)
                       I, I, I, I, I, I,  # qo kv hq hkv d dv
                       I, I, I,  # causal window splits
                       F, F, I, F, F,  # scale cap sigmoid sig_scale sig_bias
                       I, P]  # dtype stream
        if user is not None:
            fn.argtypes.append(ctypes.POINTER(UserParamsC))
        fn.restype = I
    return fn


def flash_num_splits(qo_len: int, kv_len: int, num_qo_heads: int,
                     num_kv_heads: int, dtype: torch.dtype, num_sms: int,
                     head_dim: int = 128,
                     head_dim_vo: Optional[int] = None) -> int:
    """How many CTAs share one (q tile, kv head)'s key range: 1 once the
    tiles cover half the SMs, else as many as fill the card's resident CTA
    slots in one wave (one bf16 CTA an SM, two f32), with at least 4 key
    tiles a split."""
    ctas = cdiv(qo_len * (num_qo_heads // num_kv_heads),
                _ROWS[dtype]) * num_kv_heads
    if 2 * ctas >= num_sms:
        return 1
    tile = _tile_k(dtype, head_dim, head_dim_vo or head_dim)
    return max(1, min(_CTAS_PER_SM[dtype] * num_sms // ctas,
                      cdiv(kv_len, tile) // _MIN_TILES_PER_SPLIT))


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """t with a contiguous last dim, 16-byte aligned rows and base, and no
    broadcast (zero) stride: what a TMA tensor map takes."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec or s == 0 for s in t.stride()[:-1])):
        t = t.contiguous()
    return t


def flash_attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    window_left: int = -1,
    custom_mask: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    variant: AttentionVariant = DefaultAttention,
    variant_params: Any = None,
    tile_map: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense single-request attention. q [qo_len, num_qo_heads, d]; k/v
    [kv_len, num_kv_heads, d(_vo)] (any token and head strides: an HND
    cache's transposed view is read in place); ``sink`` [num_qo_heads].
    Returns (out [qo_len, num_qo_heads, dv] in q's dtype, lse [qo_len,
    num_qo_heads] f32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``flash_attention_plain``. A variant with hooks of the caller's own
    runs in the kernel's build for that variant (``jit.variant``: traced,
    built by nvcc at first use, cached); a hook outside the traced subset
    raises ``NotImplementedError`` before any build. Under a mask (the
    custom mask, a mask hook) the kernel reads its tile map
    (``flash_tile_map``); ``tile_map=False`` runs without one (every tile
    under the mask tested key by key: the kernel's path before the map)."""
    kw = dict(causal=causal, sm_scale=sm_scale, window_left=window_left,
              custom_mask=custom_mask, sink=sink, variant=variant,
              variant_params=variant_params)
    qo_len, hq, d = q.shape
    kv_len, hkv, _ = k.shape
    mapped = tile_map and _has_mask(custom_mask, variant) and kv_len > 0 \
        and qo_len > 0
    if not q.is_cuda:
        if mapped:
            kw["tile_map"] = flash_tile_map(
                qo_len, kv_len, hq, hkv, causal=causal,
                window_left=window_left, custom_mask=custom_mask,
                variant=variant, variant_params=variant_params,
                device=q.device)
        return flash_attention_plain(q, k, v, **kw)
    dv = v.shape[-1]
    dt = q.dtype
    if dt not in _DTYPE_CODES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash kernel takes bf16 or f32 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hq % hkv or k.shape[2] != d or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit")
    if d % 16 or d > 256 or (dt == torch.bfloat16 and dv not in _BF16_DV) \
            or dv % 16 or dv > 256:
        raise ValueError(f"flash kernel takes head_dim a multiple of 16 up "
                         f"to 256 (bf16 dv in {_BF16_DV}); got d={d}, "
                         f"dv={dv}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must lie on one CUDA device")
    user = (compile_variant(variant, variant_params, "flash", hq)
            if needs_jit(variant, "flash") else None)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    # a caller's variant: its hooks replace the built-in numbers
    spec = variant.kernel if user is None else KernelVariant(
        sigmoid=None if user.softmax else (1.0, 0.0))
    softmax = spec.sigmoid is None
    alibi = None
    if spec.use_alibi:
        alibi = variant_params["alibi_slopes"].to(dev, torch.float32)
        alibi = alibi.reshape(hq).contiguous()
    mask = _packed_bits(custom_mask, qo_len, kv_len, dev)
    out_shape = (qo_len, hq, dv)
    if qo_len == 0:
        return (torch.empty(out_shape, dtype=dt, device=dev),
                torch.empty(qo_len, hq, device=dev))
    tmap = (_map_launch(user, mask, qo_len, kv_len, hq, hkv, causal,
                        window_left, variant_params, dev) if mapped else None)
    fn = _lib(user)
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    splits = flash_num_splits(qo_len, kv_len, hq, hkv, dt,
                              _num_sms(dev.index), d, dv)
    o = torch.empty(out_shape, dtype=dt, device=dev)
    lse = torch.empty(qo_len, hq, device=dev)
    o_part = lse_part = None
    if splits > 1:  # scratch for the split states the kernel merges
        o_part = torch.empty(qo_len, splits, hq, dv, device=dev)
        lse_part = torch.empty(qo_len, splits, hq, device=dev)
    sink_k = None
    if sink is not None and softmax:  # the sigmoid has no sink
        sink_k = sink.to(dev, torch.float32).reshape(hq).contiguous()
    sig_scale, sig_bias = spec.sigmoid or (1.0, 0.0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    extra = ()
    if user is not None:  # the leaves, alive until the launch is enqueued
        up, leaves = user.user_params(variant_params, dev)
        extra = (ctypes.byref(up),)
    walks = None
    if tmap is not None:  # the kernel's scratch for its CTAs' walks
        walks = torch.empty(
            cdiv(qo_len * (hq // hkv), _ROWS[torch.bfloat16]) * tmap.shape[0]
            * splits * (1 + tmap.shape[2]), dtype=torch.int32, device=dev)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), ptr(tmap),
        1 if tmap is None else tmap.shape[0], ptr(walks),
        0 if walks is None else walks.numel(), ptr(alibi),
        ptr(sink_k), o.data_ptr(), lse.data_ptr(), ptr(o_part), ptr(lse_part),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), qo_len, kv_len, hq, hkv, d, dv, int(causal),
        int(window_left), splits, float(sm_scale),
        float(spec.logits_soft_cap), int(not softmax), float(sig_scale),
        float(sig_bias), _DTYPE_CODES[dt],
        torch.cuda.current_stream(dev).cuda_stream, *extra)
    jit.check(err, "flash attention kernel")
    flash_attention_dense.launches += 1
    return o, lse


flash_attention_dense.launches = 0
flash_attention_dense.map_launches = 0  # the tile map's first launches
