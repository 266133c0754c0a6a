"""Merging partial attention states (counterpart of
``flashinfer_tpu/ops/attention/state.py``: ``merge_state``,
``merge_states`` and ``gather_merge_states``).

A state is ``(v, s)``: v the normalized partial output, s its natural-log
log-sum-exp; a state with s = -inf (no key) is the identity of the merge.
Plain PyTorch: the reference's version is not a kernel either.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gather_merge_states", "merge_state", "merge_states"]

_NEG_INF = float("-inf")


def merge_state(v_a: torch.Tensor, s_a: torch.Tensor, v_b: torch.Tensor,
                s_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two states: v [seq, heads, dim], s [seq, heads]. Returns v in
    v_a's dtype and s in f32; two empty states give v = 0, s = -inf."""
    s_a, s_b = s_a.float(), s_b.float()
    s_max = torch.maximum(s_a, s_b)
    s_max_safe = torch.where(torch.isneginf(s_max), 0.0, s_max)
    w_a = torch.where(torch.isneginf(s_a), 0.0, torch.exp(s_a - s_max_safe))
    w_b = torch.where(torch.isneginf(s_b), 0.0, torch.exp(s_b - s_max_safe))
    d = w_a + w_b
    safe_d = torch.where(d > 0, d, 1.0)
    v = (v_a.float() * (w_a / safe_d)[..., None]
         + v_b.float() * (w_b / safe_d)[..., None])
    s = torch.where(d > 0, s_max + torch.log(safe_d), _NEG_INF)
    return v.to(v_a.dtype), s


def merge_states(v: torch.Tensor, s: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge ``num_states`` states: v [seq, num_states, heads, dim], s [seq,
    num_states, heads]. Returns (v [seq, heads, dim] in v's dtype, s [seq,
    heads] f32)."""
    s = s.float()
    s_max = s.amax(dim=1, keepdim=True)
    s_max_safe = torch.where(torch.isneginf(s_max), 0.0, s_max)
    w = torch.where(torch.isneginf(s), 0.0, torch.exp(s - s_max_safe))
    d = w.sum(dim=1)  # [seq, heads]
    out = torch.einsum("lshd,lsh->lhd", v.float(), w)
    safe_d = torch.where(d > 0, d, 1.0)
    out = out / safe_d[..., None]
    s_out = torch.where(d > 0, s_max_safe[:, 0] + torch.log(safe_d), _NEG_INF)
    return out.to(v.dtype), s_out


def gather_merge_states(
    partial_o: torch.Tensor,  # [T, num_heads, tile_q, dv]
    partial_lse: torch.Tensor,  # [T, num_heads, tile_q] f32
    merge_src: torch.Tensor,  # [num_rows, max_splits] flat partial index or -1
    tile_q: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each output row, gather its partials and softmax-combine them.

    Returns (merged_o [num_rows, num_heads, dv] in partial_o's dtype,
    merged_lse [num_rows, num_heads] f32).
    """
    num_rows, max_splits = merge_src.shape
    T, h, tq, dv = partial_o.shape
    src = merge_src.long()
    w_idx = torch.clamp(torch.div(src, tile_q, rounding_mode="floor"), 0, T - 1)
    j_idx = torch.clamp(torch.remainder(src, tile_q), 0, tq - 1)
    valid = src >= 0

    # advanced indices around a slice put the index dims first: [rows, S, h]
    lse_all = partial_lse[w_idx, :, j_idx]
    lse_all = torch.where(valid[..., None], lse_all, _NEG_INF)
    m = lse_all.amax(dim=1)  # [rows, h]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    wgt = torch.where(
        torch.isneginf(lse_all), 0.0, torch.exp(lse_all - m_safe[:, None, :]))
    denom = wgt.sum(dim=1)  # [rows, h]

    acc = torch.zeros(num_rows, h, dv, dtype=torch.float32,
                      device=partial_o.device)
    for s in range(max_splits):
        o_s = partial_o[w_idx[:, s], :, j_idx[:, s], :]  # [rows, h, dv]
        acc = acc + o_s.float() * wgt[:, s, :, None]
    safe_d = torch.where(denom > 0, denom, 1.0)
    merged = (acc / safe_d[..., None]).to(partial_o.dtype)
    merged_lse = torch.where(denom > 0, m_safe + torch.log(safe_d), _NEG_INF)
    return merged, merged_lse
