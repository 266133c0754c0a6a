"""Plain PyTorch attention oracle (counterpart of
``flashinfer_tpu/ops/attention/reference.py``).

Exact (non-flash) attention in float32 with every variant hook applied,
returning ``(out, lse)`` with lse the natural-log log-sum-exp of the scaled
logits (0 for a variant without softmax).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    DefaultAttention,
)
from flashinfer_tpu_torch.utils import apply_logits_soft_cap

__all__ = ["attention_reference"]

_NEG_INF = float("-inf")


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_len: Optional[int] = None,
    q_start: Optional[int] = None,
    sm_scale: Optional[float] = None,
    window_left: int = -1,
    logits_soft_cap: float = 0.0,
    custom_mask: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    variant: AttentionVariant = DefaultAttention,
    variant_params=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [qo_len, num_qo_heads, d]; k/v: [kv_len, num_kv_heads, d(_vo)].

    Causal masking is aligned to the end of kv: query i sits at absolute
    position ``kv_len - qo_len + i`` unless ``q_start`` says otherwise.
    ``custom_mask`` [qo_len, kv_len] bool (True = keep); ``alibi_slopes``
    and ``sink`` [num_qo_heads]. ``logits_soft_cap`` is applied after the
    variant's own transform, ``alibi_slopes`` after both.
    Returns out [qo_len, heads, d_vo] (q dtype), lse [qo_len, heads] f32.
    """
    qo_len, hq, d = q.shape
    total_kv, hkv = k.shape[0], k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)

    qf = q.float()
    if variant.query_transform is not None:
        qf = variant.query_transform(variant_params, qf)
    logits = torch.einsum("qhd,khd->hqk", qf, kf) * sm_scale  # [h, q, kv]

    valid_kv = total_kv if kv_len is None else int(kv_len)
    q_pos0 = valid_kv - qo_len if q_start is None else int(q_start)
    q_pos = torch.arange(qo_len, device=q.device)[:, None] + q_pos0
    kv_pos = torch.arange(total_kv, device=q.device)[None, :]
    head_idx = torch.arange(hq, device=q.device)[:, None, None]
    if variant.logits_transform is not None:
        logits = variant.logits_transform(variant_params, logits, q_pos,
                                          kv_pos, head_idx)
    logits = apply_logits_soft_cap(logits, logits_soft_cap)
    if alibi_slopes is not None:
        logits = logits + alibi_slopes.float()[:, None, None] * (
            kv_pos - q_pos).float()[None]

    mask = kv_pos < valid_kv
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window_left >= 0:
        mask = mask & (kv_pos > q_pos - window_left - 1)
    if custom_mask is not None:
        mask = mask & custom_mask.bool()
    mask = mask[None].expand(logits.shape)
    if variant.logits_mask is not None:
        mask = mask & variant.logits_mask(variant_params, q_pos, kv_pos,
                                          head_idx)

    if not variant.use_softmax:
        weights = torch.where(mask, logits, 0.0)
        out = torch.einsum("hqk,khd->qhd", weights, vf)
        lse = torch.zeros(qo_len, hq, device=q.device)
    else:
        logits = torch.where(mask, logits, _NEG_INF)
        m = logits.amax(dim=-1)  # [h, q]
        sink_logit = None
        if sink is not None:
            sink_logit = sink.float()[:, None]
        elif variant.sink_logits is not None:
            sink_logit = variant.sink_logits(variant_params).float()[:, None]
        if sink_logit is not None:
            m = torch.maximum(m, sink_logit)
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.where(mask, torch.exp(logits - m_safe[..., None]), 0.0)
        den = p.sum(dim=-1)
        if sink_logit is not None:
            den = den + torch.exp(sink_logit - m_safe)
        safe_d = torch.where(den > 0, den, 1.0)
        out = torch.einsum("hqk,khd->qhd", p / safe_d[..., None], vf)
        lse = torch.where(den > 0, m_safe + torch.log(safe_d), _NEG_INF).T

    if variant.output_transform is not None:
        out = variant.output_transform(variant_params, out)
    return out.to(q.dtype), lse
