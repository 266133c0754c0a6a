"""Fused Mixture-of-Experts: routing and the padded grouped-GEMM pipeline.

Counterpart of flashinfer_tpu/ops/fused_moe.py: ``RoutingMethodType``,
``GatedActType``, ``route_tokens`` (:64, all six methods),
``_permute_by_expert`` (:178) and ``fused_moe`` (:315) as the pipeline of
``_fused_moe_pallas`` (:238):

  stable sort of the (token, k) pairs by expert
  -> one gather into the tile-aligned padded layout (gemm_grouped.py)
  -> grouped GEMM 1 (gate || up), the gated activation in f32
  -> grouped GEMM 2 with f32 output
  -> the inverse-permutation gather and the f32 top-k combine.

Both GEMMs run ``grouped_gemm_padded`` (the CUDA kernel on the card, its
plain version on the CPU). Everything stays on the device: group sizes are
tensors and ``m_pad`` is static, so no step syncs with the host and a call
can be captured in a CUDA graph.

Rounding follows the weights' dtype. bf16 or e4m3 weights: the rows, the
GEMM 1 output and the activation output are bf16, as in the Pallas path
(fused_moe.py:287, :291, :302). f32 weights: f32 throughout, as the JAX
package's ragged_dot path computes for f32.

A call the grouped-GEMM kernel cannot take (bf16/e4m3 weights with a GEMM's
K % 32 or N % 16, or a scale with more than one value an expert) takes the
counterpart of JAX's ragged_dot route instead (fused_moe.py:371-413), as
``backend="xla"`` does for any call: the weights dequantized to bf16 as
JAX's ``deq`` does, one ``torch.matmul`` an expert's group of rows, the
activation, the inverse gather and the combine. JAX computes that route
outside any Pallas kernel, so it is plain PyTorch here too, on the card as
on the CPU; it reads the group sizes back to the host (one sync), so it
cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch.ops.activation import gelu_and_mul, silu_and_mul
from flashinfer_tpu_torch.ops.gemm_grouped import (
    grouped_gemm_padded,
    make_group_layout,
)

__all__ = ["RoutingMethodType", "GatedActType", "route_tokens", "fused_moe"]


class RoutingMethodType(enum.IntEnum):
    Default = 0  # softmax -> top-k
    Renormalize = 1  # top-k -> softmax over the k
    DeepSeekV3 = 2  # sigmoid scores, group-limited top-k, renormalize
    Llama4 = 3  # top-1 -> sigmoid scale
    RenormalizeNaive = 4  # softmax -> top-k -> renormalize
    TopK = 5  # plain top-k scores


class GatedActType(enum.IntEnum):
    SwiGlu = 0
    GeGlu = 1


def route_tokens(
    router_logits: torch.Tensor,  # [m, num_experts] (scores for sigmoid)
    top_k: int,
    routing_method: RoutingMethodType = RoutingMethodType.Default,
    *,
    n_group: Optional[int] = None,
    topk_group: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    routing_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (expert_ids [m, k] int32, scales [m, k] f32)."""
    x = router_logits.float()
    m, e = x.shape
    if routing_method == RoutingMethodType.Default:
        scales, ids = torch.topk(torch.softmax(x, dim=-1), top_k, dim=-1)
    elif routing_method == RoutingMethodType.Renormalize:
        vals, ids = torch.topk(x, top_k, dim=-1)
        scales = torch.softmax(vals, dim=-1)
    elif routing_method == RoutingMethodType.RenormalizeNaive:
        scales, ids = torch.topk(torch.softmax(x, dim=-1), top_k, dim=-1)
        scales = scales / scales.sum(dim=-1, keepdim=True)
    elif routing_method == RoutingMethodType.Llama4:
        if top_k != 1:
            raise ValueError("Llama4 routing takes top_k == 1")
        vals, ids = torch.topk(x, 1, dim=-1)
        scales = torch.sigmoid(vals)
    elif routing_method == RoutingMethodType.TopK:
        scales, ids = torch.topk(x, top_k, dim=-1)
    elif routing_method == RoutingMethodType.DeepSeekV3:
        scores = torch.sigmoid(x)
        biased = scores if routing_bias is None else scores + routing_bias
        ng = n_group or 1
        tg = topk_group or ng
        grouped = biased.reshape(m, ng, e // ng)
        # group score: the sum of the group's top two (DeepSeek-V3 rule)
        top2 = torch.topk(grouped, min(2, e // ng), dim=-1)[0].sum(-1)
        keep = torch.topk(top2, tg, dim=-1)[1]
        group_mask = torch.zeros(m, ng, dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, keep, True)
        masked = torch.where(group_mask.repeat_interleave(e // ng, dim=1),
                             biased, float("-inf"))
        ids = torch.topk(masked, top_k, dim=-1)[1]
        picked = torch.gather(scores, 1, ids)
        scales = picked / picked.sum(dim=-1, keepdim=True)
        scales = scales * routed_scaling_factor
    else:
        raise ValueError(f"unknown routing method {routing_method}")
    return ids.to(torch.int32), scales.float()


def _permute_by_expert(expert_ids: torch.Tensor, num_experts: int):
    """Stable sort of the (token, k) pairs by expert. Returns (order [m*k],
    group_sizes [e]). The counts are an index_add, not ``bincount``, which
    reads its input's maximum back to the host on CUDA."""
    flat = expert_ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    group_sizes = torch.zeros(num_experts, dtype=torch.long,
                              device=flat.device).index_add_(
                                  0, flat, torch.ones_like(flat))
    return order, group_sizes


def select_moe_tm(rows: int, num_experts: int) -> int:
    """m-tile of the padded layout on the H100: the smallest of 16, 32 and
    64 rows that holds the average expert's share of the rows, and 128 once
    that share reaches 128 rows. At decode (8 tokens x top-6 over 64
    experts) that is 16: an expert holds at most 8 rows, so each used tile
    is at most half padding and m_pad = 48 + 64 x 16 = 1072 rows, where the
    TPU's 128-row tile gives 8320. The tile is the kernel's wgmma N, so
    larger tiles run the tensor cores nearer their rate and re-read each
    expert's weights fewer times; 128 pads an expert by 64 rows on average
    (64: 32) and adds 64 rows an expert to m_pad."""
    avg = rows / max(num_experts, 1)
    for tm in (16, 32):
        if avg <= tm:
            return tm
    return 128 if avg >= 128 else 64


def _scales_1d(s) -> bool:
    return s is None or torch.as_tensor(s).dim() <= 1


def _kernel_takes(w13: torch.Tensor, w2: torch.Tensor, w13_scale,
                  w2_scale) -> bool:
    """Whether the grouped-GEMM kernel takes both GEMMs of the call, from
    shapes, dtypes and scale ranks alone: one scale an expert (or one in
    all), and for bf16/e4m3 weights K % 32 == 0 and N % 16 == 0 (GEMM 1:
    K = hidden, N = 2 * inter; GEMM 2: K = inter, N = hidden). f32 weights
    run on the CUDA cores at any width."""
    if not (_scales_1d(w13_scale) and _scales_1d(w2_scale)):
        return False
    for w in (w13, w2):  # [e, N, K]
        if w.dtype != torch.float32 and (w.shape[2] % 32 or w.shape[1] % 16):
            return False
    return True


def _dequant(w: torch.Tensor, s) -> torch.Tensor:
    """JAX's ``deq`` (fused_moe.py:371-382): e4m3 weights, or any weights
    given a scale, become bf16, times the scale (one an expert, or one a
    weight row or column, broadcast over [e, N, K]) in f32."""
    if w.dtype == torch.float8_e4m3fn or s is not None:
        w = w.to(torch.bfloat16)
        if s is not None:
            s = torch.as_tensor(s, dtype=torch.float32, device=w.device)
            s = s.reshape(-1, 1, 1) if s.dim() <= 1 else s
            w = (w.float() * s).to(torch.bfloat16)
    return w


def _ragged_matmul(x: torch.Tensor, w: torch.Tensor, sizes, out_dtype):
    """``lax.ragged_dot(x, w^T, sizes)``: rows sorted by expert, expert e's
    rows times w[e]^T ([N, K] -> [K, N]), one f32 ``torch.matmul`` a group,
    rounded once to ``out_dtype``."""
    out = torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype,
                      device=x.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = torch.matmul(
                x[start:start + n].float(), w[e].float().T).to(out_dtype)
        start += n
    return out


def _fused_moe_ragged(hidden_states, w13, w2, expert_ids, expert_scales,
                      gated_act, w13_scale, w2_scale, out_dtype):
    """JAX's ragged_dot route (fused_moe.py:371-413) in plain PyTorch."""
    m, hidden = hidden_states.shape
    e = w13.shape[0]
    top_k = expert_ids.shape[1]
    w13, w2 = _dequant(w13, w13_scale), _dequant(w2, w2_scale)
    order, group_sizes = _permute_by_expert(expert_ids, e)
    sizes = group_sizes.tolist()  # the host loops over the groups
    x_sorted = hidden_states[order // top_k]
    h1 = _ragged_matmul(x_sorted, w13, sizes, hidden_states.dtype)
    act = silu_and_mul if gated_act == GatedActType.SwiGlu else gelu_and_mul
    h2 = _ragged_matmul(act(h1), w2, sizes, torch.float32)
    h2_tok = h2[torch.argsort(order)].reshape(m, top_k, hidden)
    out = (h2_tok * expert_scales.float()[:, :, None]).sum(dim=1)
    return out.to(out_dtype)


def fused_moe(
    hidden_states: torch.Tensor,  # [m, hidden]
    w13: torch.Tensor,  # [e, 2*inter, hidden] (gate || up rows)
    w2: torch.Tensor,  # [e, hidden, inter]
    expert_ids: torch.Tensor,  # [m, top_k]
    expert_scales: torch.Tensor,  # [m, top_k]
    *,
    gated_act: GatedActType = GatedActType.SwiGlu,
    w13_scale=None,  # per-expert (or scalar) dequant scale of e4m3 weights
    w2_scale=None,
    out_dtype: Optional[torch.dtype] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Single-device fused MoE. Weights bf16, f32 or ``float8_e4m3fn``, read
    in their [e, N, K] layout with no transposed copy.

    ``backend`` is "auto", "pallas" or "xla", as in the JAX package.
    "pallas" runs the grouped-GEMM pipeline (the kernel on a CUDA tensor,
    its plain version on a CPU tensor) and raises ``ValueError`` for a call
    the kernel cannot take; "xla" runs the ragged_dot route; "auto" the
    pipeline where the kernel takes the call, else the ragged_dot route
    (``_kernel_takes``, decided before any launch)."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    out_dtype = out_dtype or hidden_states.dtype
    takes = _kernel_takes(w13, w2, w13_scale, w2_scale)
    if backend == "pallas" and not takes:
        raise ValueError(
            "fused_moe backend='pallas' needs one scale an expert and, for "
            "bf16/e4m3 weights, K % 32 == 0 and N % 16 == 0 in both GEMMs; "
            f"got w13 {tuple(w13.shape)}, w2 {tuple(w2.shape)}")
    if backend == "xla" or not takes:
        return _fused_moe_ragged(hidden_states, w13, w2, expert_ids,
                                 expert_scales, gated_act, w13_scale,
                                 w2_scale, out_dtype)
    m, hidden = hidden_states.shape
    e = w13.shape[0]
    top_k = expert_ids.shape[1]
    work = torch.float32 if w13.dtype == torch.float32 else torch.bfloat16

    order, group_sizes = _permute_by_expert(expert_ids, e)
    token_of = order // top_k
    layout = make_group_layout(group_sizes, m * top_k,
                               select_moe_tm(m * top_k, e))

    # one gather in: token rows -> the padded layout
    row_src = torch.where(layout.src_valid, token_of[layout.src_row], 0)
    x_pad = torch.where(layout.src_valid[:, None], hidden_states[row_src],
                        0).to(work)
    h1 = grouped_gemm_padded(x_pad, w13, layout.expert_of_tile, w13_scale,
                             out_dtype=work, rhs_nk=True)
    act = silu_and_mul if gated_act == GatedActType.SwiGlu else gelu_and_mul
    h_mid = act(h1)  # f32 math, rounded to the working dtype
    # f32 output: it feeds the f32 top-k combine
    h2 = grouped_gemm_padded(h_mid, w2, layout.expert_of_tile, w2_scale,
                             out_dtype=torch.float32, rhs_nk=True)
    inv = torch.argsort(order)
    h2_tok = h2[layout.padded_pos[inv]].reshape(m, top_k, hidden)
    out = (h2_tok * expert_scales.float()[:, :, None]).sum(dim=1)
    return out.to(out_dtype)
