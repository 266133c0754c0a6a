"""Single-request attention (counterpart of
``flashinfer_tpu/ops/attention/single.py``): ``single_prefill_with_kv_cache``
and ``single_decode_with_kv_cache`` over a dense KV.

Backends: "auto" runs ``flash_attention_dense`` (the CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor); "reference" runs the
oracle ``attention_reference``. "pallas" names the TPU kernel and is
refused.

Kept as the JAX package has them: ROPE_LLAMA rotates q and k with
``apply_rope_pos_ids``'s defaults (theta 1e4, whatever the model), queries
at the tail of the sequence; ALiBi slopes are dropped when the caller
passes a variant; decode runs non-causal with its one query at the end.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch

from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
)
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    make_default_variant,
)
from flashinfer_tpu_torch.ops.quantization import unpackbits
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.utils import (
    PosEncodingMode,
    TensorLayout,
    check_kv_layout,
    resolve_device,
)

__all__ = [
    "default_alibi_slopes",
    "single_decode_with_kv_cache",
    "single_prefill_with_kv_cache",
]


def default_alibi_slopes(num_heads: int, device="cuda") -> torch.Tensor:
    """The standard ALiBi slope schedule (Press et al.), f32 [num_heads],
    made on ``device`` (no host copy, so a CUDA graph can hold it)."""
    device = resolve_device(device)
    closest = 2 ** math.floor(math.log2(num_heads))
    base = torch.arange(1, closest + 1, dtype=torch.float32, device=device)
    slopes = 2.0 ** (-8.0 * base / closest)
    if closest != num_heads:
        extra = torch.arange(1, 2 * (num_heads - closest) + 1, 2,
                             dtype=torch.float32, device=device)
        slopes = torch.cat([slopes, 2.0 ** (-4.0 * extra / closest)])
    return slopes[:num_heads]


def _canon_pos_mode(mode) -> PosEncodingMode:
    if isinstance(mode, str):
        return PosEncodingMode[mode.upper()]
    return PosEncodingMode(mode)


def single_prefill_with_kv_cache(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    custom_mask: Optional[torch.Tensor] = None,
    packed_custom_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    kv_layout: str = "NHD",
    pos_encoding_mode: Union[str, PosEncodingMode] = "NONE",
    sm_scale: Optional[float] = None,
    window_left: int = -1,
    logits_soft_cap: float = 0.0,
    sink: Optional[torch.Tensor] = None,
    return_lse: bool = False,
    backend: str = "auto",
    variant: Optional[AttentionVariant] = None,
    variant_params: Any = None,
):
    """Prefill/append attention between q and a dense KV.

    q [qo_len, num_qo_heads, head_dim]; k/v per ``kv_layout`` (NHD
    [kv_len, num_kv_heads, d], HND [num_kv_heads, kv_len, d]; an HND KV is
    read in place through its strides). ``custom_mask`` [qo_len, kv_len]
    bool, or ``packed_custom_mask`` its bits packed "big" as
    ``ops.quantization.packbits`` packs them. Returns out [qo_len, heads,
    dv], and lse [qo_len, heads] f32 with ``return_lse``."""
    if backend not in ("auto", "reference"):
        raise ValueError(f"unknown backend {backend!r}: the port runs 'auto' "
                         "(its kernel) or 'reference' ('pallas' names the "
                         "TPU kernel)")
    if check_kv_layout(kv_layout) == TensorLayout.HND:
        k, v = k.transpose(0, 1), v.transpose(0, 1)
    qo_len, kv_len = q.shape[0], k.shape[0]
    if custom_mask is None and packed_custom_mask is not None:
        custom_mask = packed_custom_mask.to(torch.uint8)
        if backend == "reference":
            custom_mask = unpackbits(custom_mask, qo_len * kv_len).reshape(
                qo_len, kv_len)

    mode = _canon_pos_mode(pos_encoding_mode)
    alibi = None
    if mode == PosEncodingMode.ALIBI:
        alibi = default_alibi_slopes(q.shape[1], q.device)
    elif mode == PosEncodingMode.ROPE_LLAMA:
        q_pos = kv_len - qo_len + torch.arange(qo_len, device=q.device)
        k_pos = torch.arange(kv_len, device=q.device)
        q, _ = apply_rope_pos_ids(q, q[:, :1], q_pos)
        k, _ = apply_rope_pos_ids(k, k[:, :1], k_pos)

    if variant is None:
        variant = make_default_variant(logits_soft_cap=logits_soft_cap,
                                       use_alibi=alibi is not None)
        if alibi is not None:
            variant_params = {"alibi_slopes": alibi}

    kw = dict(causal=causal, sm_scale=sm_scale, window_left=window_left,
              custom_mask=custom_mask, sink=sink, variant=variant,
              variant_params=variant_params)
    if backend == "reference":
        out, lse = attention_reference(q, k, v, **kw)
    else:
        out, lse = flash_attention_dense(q, k, v, **kw)
    return (out, lse) if return_lse else out


def single_decode_with_kv_cache(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_layout: str = "NHD",
    pos_encoding_mode: Union[str, PosEncodingMode] = "NONE",
    sm_scale: Optional[float] = None,
    window_left: int = -1,
    logits_soft_cap: float = 0.0,
    return_lse: bool = False,
    backend: str = "auto",
    variant: Optional[AttentionVariant] = None,
    variant_params: Any = None,
):
    """Single-request decode: q is one token [num_qo_heads, head_dim], at
    the end of the KV, which it sees whole (no causal mask)."""
    out = single_prefill_with_kv_cache(
        q[None], k, v, causal=False, kv_layout=kv_layout,
        pos_encoding_mode=pos_encoding_mode, sm_scale=sm_scale,
        window_left=window_left, logits_soft_cap=logits_soft_cap,
        return_lse=return_lse, backend=backend, variant=variant,
        variant_params=variant_params)
    if return_lse:
        o, lse = out
        return o[0], lse[0]
    return out[0]
