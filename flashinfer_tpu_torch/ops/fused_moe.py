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

The four API entry points of JAX's module (fused_moe.py:416-544) each end
in ``fused_moe``, so on the card in the grouped-GEMM kernel:
``cutlass_fused_moe`` (routing given), ``trtllm_fp8_per_tensor_scale_moe``
(``route_tokens``, then e4m3 weights with scalar scales),
``trtllm_fp8_block_scale_moe`` (e4m3 weights with a scale a 128 x 128 block
and e4m3 rows with a scale a 128-wide block, dequantized to bf16 by JAX's
bit decode first) and ``trtllm_fp4_block_scale_moe`` (mxfp4 weights
dequantized to bf16 first). The block-scale dequantization is plain
PyTorch on every call, as JAX computes it outside any Pallas kernel. Each
takes ``backend`` and hands it to ``fused_moe``: "xla" runs the plain
ragged_dot route, the plain version the card checks hold the kernel to.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence, Tuple

import torch

from flashinfer_tpu_torch.ops.activation import gelu_and_mul, silu_and_mul
from flashinfer_tpu_torch.ops.fp4 import fp4_dequantize
from flashinfer_tpu_torch.ops.fp8 import fp8_to_bf16
from flashinfer_tpu_torch.ops.gemm_grouped import (
    grouped_gemm_padded,
    make_group_layout,
)

__all__ = [
    "RoutingMethodType",
    "GatedActType",
    "route_tokens",
    "fused_moe",
    "cutlass_fused_moe",
    "trtllm_fp8_per_tensor_scale_moe",
    "trtllm_fp8_block_scale_moe",
    "trtllm_fp4_block_scale_moe",
]


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
                  w2_scale, weights_kn: bool = False) -> bool:
    """Whether the grouped-GEMM kernel takes both GEMMs of the call, from
    shapes, dtypes and scale ranks alone: one scale an expert (or one in
    all), and for bf16/e4m3 weights K % 32 == 0 and N % 16 == 0 (GEMM 1:
    K = hidden, N = 2 * inter; GEMM 2: K = inter, N = hidden), read from
    the layout the weights are stored in ([e, N, K], or [e, K, N] with
    ``weights_kn``). f32 weights run on the CUDA cores at any width."""
    if not (_scales_1d(w13_scale) and _scales_1d(w2_scale)):
        return False
    for w in (w13, w2):
        n, k = (w.shape[2], w.shape[1]) if weights_kn else (w.shape[1],
                                                           w.shape[2])
        if w.dtype != torch.float32 and (k % 32 or n % 16):
            return False
    return True


def _dequant(w: torch.Tensor, s, ftz: bool = False) -> torch.Tensor:
    """JAX's ``deq`` (fused_moe.py:371-382): e4m3 weights, or any weights
    given a scale, become bf16, times the scale (one an expert, or one a
    weight row or column, broadcast over [e, N, K]) in f32. ``ftz``: e4m3
    through JAX's bit decode (denormals to zero), as it decodes its int8
    containers."""
    if w.dtype == torch.float8_e4m3fn or s is not None:
        w = (fp8_to_bf16(w) if ftz and w.dtype == torch.float8_e4m3fn
             else w.to(torch.bfloat16))
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
                      gated_act, w13_scale, w2_scale, out_dtype,
                      ftz=(False, False)):
    """JAX's ragged_dot route (fused_moe.py:371-413) in plain PyTorch, on
    [e, N, K] weights (views of [e, K, N] ones)."""
    m, hidden = hidden_states.shape
    e = w13.shape[0]
    top_k = expert_ids.shape[1]
    w13, w2 = _dequant(w13, w13_scale, ftz[0]), _dequant(w2, w2_scale, ftz[1])
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
    weights_kn: bool = False,  # weights stored [e, K, N]
) -> torch.Tensor:
    """Single-device fused MoE. Weights bf16, f32, ``float8_e4m3fn`` or int8
    holding e4m3 bits (the JAX package's containers, read as JAX reads
    them: viewed as e4m3 without a copy, decoded with denormals flushed),
    read in the layout they are stored in with no transposed copy: [e, N,
    K] (w13 [e, 2 * inter, hidden], w2 [e, hidden, inter]), or [e, K, N]
    with ``weights_kn`` (the grouped GEMM reads both).

    ``backend`` is "auto", "pallas" or "xla", as in the JAX package.
    "pallas" runs the grouped-GEMM pipeline (the kernel on a CUDA tensor,
    its plain version on a CPU tensor) and raises ``ValueError`` for a call
    the kernel cannot take; "xla" runs the ragged_dot route; "auto" the
    pipeline where the kernel takes the call, else the ragged_dot route
    (``_kernel_takes``, decided before any launch)."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    out_dtype = out_dtype or hidden_states.dtype
    # JAX's e4m3 containers: decoded as JAX decodes them (denormals to 0)
    ftz13, ftz2 = w13.dtype == torch.int8, w2.dtype == torch.int8
    w13, w2 = (w.view(torch.float8_e4m3fn) if w.dtype == torch.int8 else w
               for w in (w13, w2))
    takes = _kernel_takes(w13, w2, w13_scale, w2_scale, weights_kn)
    if backend == "pallas" and not takes:
        raise ValueError(
            "fused_moe backend='pallas' needs one scale an expert and, for "
            "bf16/e4m3 weights, K % 32 == 0 and N % 16 == 0 in both GEMMs; "
            f"got w13 {tuple(w13.shape)}, w2 {tuple(w2.shape)}")
    if backend == "xla" or not takes:
        if weights_kn:
            w13, w2 = w13.transpose(1, 2), w2.transpose(1, 2)
        return _fused_moe_ragged(hidden_states, w13, w2, expert_ids,
                                 expert_scales, gated_act, w13_scale,
                                 w2_scale, out_dtype, (ftz13, ftz2))
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
                             out_dtype=work, rhs_nk=not weights_kn,
                             e4m3_ftz=ftz13)
    act = silu_and_mul if gated_act == GatedActType.SwiGlu else gelu_and_mul
    h_mid = act(h1)  # f32 math, rounded to the working dtype
    # f32 output: it feeds the f32 top-k combine
    h2 = grouped_gemm_padded(h_mid, w2, layout.expert_of_tile, w2_scale,
                             out_dtype=torch.float32, rhs_nk=not weights_kn,
                             e4m3_ftz=ftz2)
    inv = torch.argsort(order)
    h2_tok = h2[layout.padded_pos[inv]].reshape(m, top_k, hidden)
    out = (h2_tok * expert_scales.float()[:, :, None]).sum(dim=1)
    return out.to(out_dtype)


def cutlass_fused_moe(
    input: torch.Tensor,
    token_selected_experts: torch.Tensor,
    token_final_scales: torch.Tensor,
    fc1_expert_weights: torch.Tensor,
    fc2_expert_weights: torch.Tensor,
    output_dtype: Optional[torch.dtype] = None,
    *,
    quant_scales: Sequence[torch.Tensor] = (),
    tp_size: int = 1,
    tp_rank: int = 0,
    ep_size: int = 1,
    ep_rank: int = 0,
    backend: str = "auto",
    **_compat,
) -> torch.Tensor:
    """The reference's API entry point (flashinfer_tpu/ops/fused_moe.py:
    416): ``fused_moe`` on routing the caller chose, ``quant_scales`` as
    (w13 scale, w2 scale). The tp/ep arguments are accepted; a sharded
    layer passes its local weights and expert ids, as in the JAX package."""
    return fused_moe(
        input, fc1_expert_weights, fc2_expert_weights,
        token_selected_experts, token_final_scales,
        w13_scale=quant_scales[0] if len(quant_scales) > 0 else None,
        w2_scale=quant_scales[1] if len(quant_scales) > 1 else None,
        out_dtype=output_dtype, backend=backend)


def trtllm_fp8_per_tensor_scale_moe(
    routing_logits: torch.Tensor,
    routing_bias: Optional[torch.Tensor],
    hidden_states: torch.Tensor,
    gemm1_weights: torch.Tensor,
    output1_scales_scalar,
    gemm2_weights: torch.Tensor,
    output2_scales_scalar,
    num_experts: int,
    top_k: int,
    n_group: Optional[int],
    topk_group: Optional[int],
    intermediate_size: int,
    local_expert_offset: int = 0,
    local_num_experts: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    use_routing_scales_on_input: bool = False,
    routing_method_type: RoutingMethodType = RoutingMethodType.Default,
    *,
    backend: str = "auto",
    **_compat,
) -> torch.Tensor:
    """Routing, then the MoE on e4m3 weights with one scale a GEMM (JAX's
    fused_moe.py:448). Returns bf16."""
    ids, scales = route_tokens(
        routing_logits, top_k, routing_method_type, n_group=n_group,
        topk_group=topk_group, routed_scaling_factor=routed_scaling_factor,
        routing_bias=routing_bias)
    return fused_moe(hidden_states, gemm1_weights, gemm2_weights, ids, scales,
                     w13_scale=output1_scales_scalar,
                     w2_scale=output2_scales_scalar, out_dtype=torch.bfloat16,
                     backend=backend)


_BLOCK = 128  # the block-scale entry point's scale block (both dims)
# experts dequantized at a time: bounds the f32 temporaries of a
# DeepSeek-V3 layer's 256 [4096, 7168] weights to ~2 GB
_DEQUANT_EXPERTS = 8


def _dequant_block_fp8(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """JAX's ``deq_block`` (fused_moe.py:483): e4m3 w [e, n, k] times its
    scale s [e, n / 128, k / 128] broadcast over each 128 x 128 block, by
    the bit decode (denormals to zero), in f32, rounded once to bf16."""
    e, n, k = w.shape
    out = torch.empty(e, n, k, dtype=torch.bfloat16, device=w.device)
    for e0 in range(0, e, _DEQUANT_EXPERTS):
        e1 = min(e, e0 + _DEQUANT_EXPERTS)
        sn = s[e0:e1].float().repeat_interleave(_BLOCK, 1).repeat_interleave(
            _BLOCK, 2)[:, :n, :k]
        out[e0:e1] = (fp8_to_bf16(w[e0:e1]).float() * sn).to(torch.bfloat16)
    return out


def _dequant_rows_fp8(hs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e4m3 rows [m, k] times a scale a 128-wide block [m, k / 128] (JAX's
    fused_moe.py:500-507), in f32, rounded once to bf16."""
    m, k = hs.shape
    hsf = fp8_to_bf16(hs).float().reshape(m, k // _BLOCK, _BLOCK)
    return (hsf * scale.float()[..., None]).reshape(m, k).to(torch.bfloat16)


def trtllm_fp8_block_scale_moe(
    routing_logits, routing_bias, hidden_states, hidden_states_scale,
    gemm1_weights, gemm1_weights_scale, gemm2_weights, gemm2_weights_scale,
    num_experts, top_k, n_group, topk_group, intermediate_size,
    local_expert_offset: int = 0, local_num_experts: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    routing_method_type: RoutingMethodType = RoutingMethodType.DeepSeekV3,
    *,
    backend: str = "auto",
    **_compat,
) -> torch.Tensor:
    """e4m3 weights with a scale a 128 x 128 block (w13 [e, 2 * inter,
    hidden] with [e, 2 * inter / 128, hidden / 128], w2 likewise) and e4m3
    rows with a scale a 128-wide block ([m, hidden / 128]; bf16 rows with
    ``hidden_states_scale`` None): routing, every weight dequantized to
    bf16, then the bf16 MoE (JAX's fused_moe.py:478). Returns bf16."""
    ids, scales = route_tokens(
        routing_logits, top_k, routing_method_type, n_group=n_group,
        topk_group=topk_group, routed_scaling_factor=routed_scaling_factor,
        routing_bias=routing_bias)
    hs = hidden_states
    if hidden_states_scale is not None:
        hs = _dequant_rows_fp8(hs, hidden_states_scale)
    return fused_moe(
        hs, _dequant_block_fp8(gemm1_weights, gemm1_weights_scale),
        _dequant_block_fp8(gemm2_weights, gemm2_weights_scale), ids, scales,
        out_dtype=torch.bfloat16, backend=backend)


def _dequant_mxfp4(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """mxfp4 weights (two e2m1 codes a byte, an e8m0 scale a 32-wide block)
    as bf16: ``fp4_dequantize(sf_vec_size=32, sf_use_ue8m0=True)`` a few
    experts at a time."""
    e = w.shape[0]
    parts = [fp4_dequantize(w[e0:e0 + _DEQUANT_EXPERTS],
                            s[e0:e0 + _DEQUANT_EXPERTS], sf_vec_size=32,
                            sf_use_ue8m0=True, dtype=torch.bfloat16)
             for e0 in range(0, e, _DEQUANT_EXPERTS)]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def trtllm_fp4_block_scale_moe(
    routing_logits, routing_bias, hidden_states, hidden_states_scale,
    gemm1_weights, gemm1_weights_scale, gemm2_weights, gemm2_weights_scale,
    *args, num_experts=None, top_k: int = 1, n_group=None, topk_group=None,
    intermediate_size=None, routed_scaling_factor: float = 1.0,
    routing_method_type: RoutingMethodType = RoutingMethodType.Renormalize,
    backend: str = "auto",
    **_compat,
) -> torch.Tensor:
    """mxfp4 weights (w13 uint8 [e, 2 * inter, hidden / 2] with e8m0 scales
    [e, 2 * inter, hidden / 32], w2 likewise): routing, the weights
    dequantized to bf16, then the bf16 MoE (JAX's fused_moe.py:521). The
    rows are taken as given. Returns bf16."""
    ids, scales = route_tokens(
        routing_logits, top_k, routing_method_type, n_group=n_group,
        topk_group=topk_group, routed_scaling_factor=routed_scaling_factor,
        routing_bias=routing_bias)
    return fused_moe(
        hidden_states, _dequant_mxfp4(gemm1_weights, gemm1_weights_scale),
        _dequant_mxfp4(gemm2_weights, gemm2_weights_scale), ids, scales,
        out_dtype=torch.bfloat16, backend=backend)
