"""Sharded MoE layers: tensor parallelism over the intermediate dimension
(``fused_moe_tp``) and expert parallelism with all-to-all dispatch
(``fused_moe_ep``, optionally with each expert's intermediate dimension
sharded too).

Counterpart of ``flashinfer_tpu/parallel/moe.py``: the per-rank body of its
``shard_map``, on this rank's shards. The local expert MLP is
``ops.fused_moe.fused_moe`` (the grouped-GEMM kernel on the card), so bf16,
f32 and e4m3 weights (one scale an expert) all come along. Dispatch is
capacity-based (``MoeAlltoAll``): shapes are fixed whatever the routing.

Intermediate-dimension shards keep gate and up aligned: w13 [E, 2 * inter,
hidden] is viewed as [E, 2, inter, hidden] (``shard_w13_for_tp``) and
sharded on dimension 2, so a rank holds the same inter slice of the gate
half and of the up half, [E, 2 * inter / tp, hidden] (gate rows, then up
rows) once reshaped.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.ops.fused_moe import (
    GatedActType,
    RoutingMethodType,
    fused_moe,
    route_tokens,
)
from flashinfer_tpu_torch.parallel.collectives import MoeAlltoAll, all_reduce
from flashinfer_tpu_torch.parallel.mesh import axis_rank, axis_size

__all__ = ["fused_moe_ep", "fused_moe_tp", "moe_ep_capacity"]


def shard_w13_for_tp(w13):
    """w13 [E, 2 * inter, hidden] as [E, 2, inter, hidden] (a view), the
    layout whose dimension 2 the intermediate shards split."""
    e, two_inter, hidden = w13.shape
    return w13.reshape(e, 2, two_inter // 2, hidden)


def fused_moe_tp(
    hidden_states: torch.Tensor,
    router_logits: torch.Tensor,
    w13: torch.Tensor,
    w2: torch.Tensor,
    mesh: Optional[DeviceMesh],
    *,
    top_k: int,
    axis_name: str = "moe_tp",
    routing_method: RoutingMethodType = RoutingMethodType.Default,
    gated_act: GatedActType = GatedActType.SwiGlu,
    n_group: Optional[int] = None,
    topk_group: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    routing_bias: Optional[torch.Tensor] = None,
    w13_scale=None,
    w2_scale=None,
    backend: str = "auto",
) -> torch.Tensor:
    """MoE tensor parallelism: every rank holds all experts and 1 / tp of
    the intermediate dimension; the down-projection partials (f32) sum
    with one all-reduce. Exact: no capacity, no drops.

    hidden_states [tokens, hidden] and router_logits [tokens, E] are
    replicated over ``axis_name``; w13 is this rank's [E, 2 * inter / tp,
    hidden] (``shard_w13_for_tp``'s dimension 2 over ``axis_name``), w2
    [E, hidden, inter / tp] (dimension 2 over ``axis_name``); the scales
    (one an expert, or one in all) are replicated. Returns [tokens, hidden]
    in hidden_states' dtype, replicated. The kernel reads contiguous
    weights: a shard passed as a view (``local_shard``'s) is copied each
    call, so keep the shards contiguous."""
    w13, w2 = w13.contiguous(), w2.contiguous()
    ids, scales = route_tokens(
        router_logits, top_k, routing_method, n_group=n_group,
        topk_group=topk_group, routed_scaling_factor=routed_scaling_factor,
        routing_bias=routing_bias)
    y = fused_moe(hidden_states, w13, w2, ids, scales, gated_act=gated_act,
                  w13_scale=w13_scale, w2_scale=w2_scale, backend=backend,
                  out_dtype=torch.float32)
    return all_reduce(y, axis_name, mesh=mesh).to(hidden_states.dtype)


def moe_ep_capacity(tokens_per_device: int, top_k: int, ep: int,
                    capacity_factor: float = 1.5) -> int:
    """Per-peer send capacity: the expected copies a peer times a slack
    factor, at least 8."""
    expected = tokens_per_device * top_k / ep
    return max(8, int(expected * capacity_factor + 0.5))


def _expert_scales(s, num_experts: int, device) -> torch.Tensor:
    if s is None:
        return torch.ones(num_experts, dtype=torch.float32, device=device)
    return torch.as_tensor(s, dtype=torch.float32, device=device).reshape(
        -1).expand(num_experts)


def fused_moe_ep(
    hidden_states: torch.Tensor,
    router_logits: torch.Tensor,
    w13: torch.Tensor,
    w2: torch.Tensor,
    mesh: Optional[DeviceMesh],
    *,
    top_k: int,
    axis_name: str = "ep",
    routing_method: RoutingMethodType = RoutingMethodType.Default,
    gated_act: GatedActType = GatedActType.SwiGlu,
    capacity: Optional[int] = None,
    capacity_factor: float = 1.5,
    n_group: Optional[int] = None,
    topk_group: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    routing_bias: Optional[torch.Tensor] = None,
    w13_scale=None,
    w2_scale=None,
    backend: str = "auto",
    tp_axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Expert parallelism: tokens and experts sharded over ``axis_name``
    (expert e on rank e // (E / ep)); route, dispatch, the local experts'
    MLP, combine.

    hidden_states [tokens / ep, hidden] and router_logits [tokens / ep, E]
    are this rank's tokens (dimension 0 over ``axis_name``); w13 [E / ep,
    2 * inter, hidden] and w2 [E / ep, hidden, inter] its experts
    (dimension 0 over ``axis_name``). ``w13_scale`` / ``w2_scale`` are one
    scale for each of the E experts (or one in all): each rank takes its
    experts' slice, as JAX shards them with the experts. With
    ``tp_axis_name`` (the moe_tp x ep factorization) each expert's
    intermediate dimension is further sharded over it (w13 [E / ep,
    2 * inter / tp, hidden] by ``shard_w13_for_tp``, w2 [E / ep, hidden,
    inter / tp]; tokens replicated over it), and the down-projection
    partials sum over it before the combine. A copy past ``capacity``
    (default ``moe_ep_capacity``) is dropped: it contributes zero. Returns
    this rank's tokens [tokens / ep, hidden]. Weights as in
    ``fused_moe_tp``: a view is copied each call."""
    w13, w2 = w13.contiguous(), w2.contiguous()
    ep = axis_size(mesh, axis_name)
    my = axis_rank(mesh, axis_name)
    eper, _, hidden = w13.shape
    num_experts = eper * ep
    if capacity is None:
        capacity = moe_ep_capacity(hidden_states.shape[0], top_k, ep,
                                   capacity_factor)
    a2a = MoeAlltoAll(num_experts, capacity, axis_name, mesh=mesh)
    have_scales = w13_scale is not None or w2_scale is not None
    dev = hidden_states.device
    mine = slice(my * eper, (my + 1) * eper)
    s13 = _expert_scales(w13_scale, num_experts, dev)[mine]
    s2 = _expert_scales(w2_scale, num_experts, dev)[mine]

    ids, scales = route_tokens(
        router_logits, top_k, routing_method, n_group=n_group,
        topk_group=topk_group, routed_scaling_factor=routed_scaling_factor,
        routing_bias=routing_bias)
    recv_x, recv_e, send_slot = a2a.dispatch(hidden_states, ids)
    # received copies carry global expert ids in this rank's range; empty
    # slots (-1) clamp to expert 0, and the combine drops their outputs
    local_e = torch.clamp(recv_e - my * eper, 0, eper - 1).to(torch.int32)
    y = fused_moe(
        recv_x, w13, w2, local_e[:, None],
        torch.ones(recv_x.shape[0], 1, dtype=torch.float32, device=dev),
        gated_act=gated_act,
        w13_scale=s13 if have_scales else None,
        w2_scale=s2 if have_scales else None,
        backend=backend, out_dtype=torch.float32)
    if tp_axis_name is not None:
        y = all_reduce(y, tp_axis_name, mesh=mesh)
    return a2a.combine(y.to(hidden_states.dtype), send_slot, ids, scales)
