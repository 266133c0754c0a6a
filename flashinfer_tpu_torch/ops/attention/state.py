"""Merging partial attention states (counterpart of
``flashinfer_tpu/ops/attention/state.py``: ``merge_state``,
``merge_state_in_place``, ``merge_states``,
``variable_length_merge_states``, ``scatter_merge_states`` and
``gather_merge_states``).

A state is ``(v, s)``: v the normalized partial output, s its natural-log
log-sum-exp; a state with s = -inf (no key) is the identity of the merge.
Plain PyTorch: the reference's version is not a kernel either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["gather_merge_states", "merge_state", "merge_state_in_place",
           "merge_states", "scatter_merge_states",
           "variable_length_merge_states"]

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


def merge_state_in_place(v: torch.Tensor, s: torch.Tensor,
                         v_other: torch.Tensor, s_other: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge (v_other, s_other) into (v, s), writing v and s in place, and
    return them (the JAX package returns the merged pair instead). ``mask``
    [seq] bool: rows where it is False keep their state."""
    v_new, s_new = merge_state(v, s, v_other, s_other)
    if mask is not None:
        keep = mask.to(device=v.device, dtype=torch.bool)
        v_new = torch.where(keep[:, None, None], v_new, v)
        s_new = torch.where(keep[:, None], s_new, s.float())
    v.copy_(v_new)
    s.copy_(s_new)
    return v, s


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


def variable_length_merge_states(v: torch.Tensor, s: torch.Tensor,
                                 merge_indptr: torch.Tensor, num_rows: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-merge split-KV partials: output row i merges the partials at
    rows ``merge_indptr[i]:merge_indptr[i + 1]`` of v [total, heads, dim]
    and s [total, heads]. Partials outside every segment are ignored."""
    total = v.shape[0]
    idx = torch.arange(total, device=v.device,
                       dtype=merge_indptr.dtype)
    row = torch.searchsorted(merge_indptr, idx, right=True) - 1
    return scatter_merge_states(v, s, row, num_rows)


def scatter_merge_states(v: torch.Tensor, s: torch.Tensor,
                         out_row: torch.Tensor, num_rows: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partials v [total, heads, dim], s [total, heads] into
    ``num_rows`` rows: partial i goes to row ``out_row[i]``. A negative
    row drops the partial (its v and s may hold NaN or garbage and do not
    reach the result); a row past the last goes to a trash row that is cut
    off. Scatter-reduces on the device, no host sync. Returns (v [num_rows,
    heads, dim] in v's dtype, s [num_rows, heads] f32); a row no partial
    reaches is v = 0, s = -inf."""
    total, h = s.shape
    dropped = out_row < 0
    row = torch.where(dropped | (out_row > num_rows), num_rows,
                      out_row).long()
    s = torch.where(dropped[:, None], _NEG_INF, s.float())
    nseg = num_rows + 1
    s_max = torch.full((nseg, h), _NEG_INF, device=s.device).scatter_reduce(
        0, row[:, None].expand(total, h), s, "amax")
    s_max_g = s_max[row]
    w = torch.where(torch.isneginf(s), 0.0, torch.exp(
        s - torch.where(torch.isneginf(s_max_g), 0.0, s_max_g)))
    d = torch.zeros(nseg, h, device=s.device).index_add_(0, row, w)
    v_w = torch.where(dropped[:, None, None], 0.0, v.float()) * w[..., None]
    v_sum = torch.zeros(nseg, h, v.shape[-1], device=v.device).index_add_(
        0, row, v_w)
    safe_d = torch.where(d > 0, d, 1.0)
    s_out = torch.where(d > 0, torch.where(torch.isneginf(s_max), 0.0, s_max)
                        + torch.log(safe_d), _NEG_INF)
    v_out = v_sum / safe_d[..., None]
    return v_out[:num_rows].to(v.dtype), s_out[:num_rows]


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
