"""Pipeline parallelism: a GPipe microbatch pipeline over the mesh dimension
``pp``.

Counterpart of ``flashinfer_tpu/parallel/pipeline.py``. Stage s runs on
the rank at coordinate s along ``axis_name``. At tick t stage s applies its
stage function to microbatch t - s (stage 0 reads it from the input, the
others receive it from stage s - 1) and sends the result to stage s + 1
(``batch_isend_irecv``); the last stage keeps it. A stage computes only on
its ticks, so the (pp - 1) / (num_microbatches + pp - 1) bubble is idle
rather than spent on padding as in JAX's scan. At the end the last stage
broadcasts the outputs over the pp group, so every rank returns them (in
JAX any process can read the global result). Activations keep one shape
through the stages; the shape-changing ends of a model (embedding,
lm_head) run outside the pipeline, as in ``llama_forward_pipelined``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.parallel.mesh import (
    axis_group,
    axis_peer,
    axis_rank,
    axis_size,
)

__all__ = ["pipeline_forward", "llama_forward_pipelined"]


def pipeline_forward(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh: Optional[DeviceMesh],
    *,
    axis_name: str = "pp",
) -> torch.Tensor:
    """Run ``stage_fn(stage_params, activations) -> activations`` (shape
    preserving) as a pp-deep pipeline over microbatches.

    stage_params: this rank's stage's parameters (JAX's leading pp axis
    sharded over ``axis_name``, so without it). x: [num_microbatches, mb,
    ...], replicated. Returns [num_microbatches, mb, ...], the last stage's
    outputs, on every rank."""
    pp = axis_size(mesh, axis_name)
    stage = axis_rank(mesh, axis_name)
    num_micro = x.shape[0]
    out = torch.empty_like(x) if stage == pp - 1 else None
    group = axis_group(mesh, axis_name)
    nxt = axis_peer(mesh, axis_name, stage + 1) if stage < pp - 1 else None
    prv = axis_peer(mesh, axis_name, stage - 1) if stage > 0 else None
    if pp > 1:
        # NCCL makes a group's communicator in a call of all its ranks; the
        # ticks' sends pair two ranks, so make it first
        dist.barrier(group=group)
    inbox = None
    for t in range(num_micro + pp - 1):
        mb = t - stage  # the microbatch this stage holds at tick t
        ops = []
        if 0 <= mb < num_micro:
            y = stage_fn(stage_params, x[mb] if stage == 0 else inbox)
            if nxt is None:
                out[mb] = y
            else:
                ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt,
                                      group=group))
        if prv is not None and 0 <= mb + 1 < num_micro:
            inbox = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, inbox, prv, group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if pp > 1:
        if out is None:
            out = torch.empty_like(x)
        dist.broadcast(out, src=axis_peer(mesh, axis_name, pp - 1),
                       group=group)
    return out


def llama_forward_pipelined(
    params: Dict[str, torch.Tensor],
    token_ids: torch.Tensor,
    cfg,
    mesh: Optional[DeviceMesh],
    *,
    num_microbatches: int,
    axis_name: str = "pp",
) -> torch.Tensor:
    """The Llama forward with its layers as a pp-deep pipeline, equal to
    ``llama_forward_dense``: logits [batch, seq, vocab] f32 on every rank.

    Stage s holds layers s * L / pp .. (s + 1) * L / pp: the per-layer
    weights of ``params`` are this stage's [L / pp, ...] (JAX's [L, ...]
    stacks sharded over ``axis_name``); embedding, final norm and lm_head
    are replicated and run outside the pipeline, on every rank.
    ``token_ids`` [batch, seq], batch a multiple of ``num_microbatches``."""
    from flashinfer_tpu_torch.models.llama import PER_LAYER, llama_dense_layer
    from flashinfer_tpu_torch.ops.norm import rmsnorm

    pp = axis_size(mesh, axis_name)
    L = cfg.num_layers
    if L % pp:
        raise ValueError(f"{L} layers do not split into {pp} stages")
    per_stage = L // pp
    B, S = token_ids.shape
    if B % num_microbatches:
        raise ValueError(f"batch {B} does not split into "
                         f"{num_microbatches} microbatches")
    layers = {k: params[k] for k in PER_LAYER if k in params}
    x = params["embedding"][token_ids]  # [B, S, h]
    x = x.reshape(num_microbatches, B // num_microbatches, S, -1)
    pos = torch.arange(S, device=token_ids.device)

    def stage_fn(sp, h):
        for i in range(per_stage):
            h = llama_dense_layer({k: w[i] for k, w in sp.items()}, h, pos,
                                  cfg)
        return h

    x = pipeline_forward(stage_fn, layers, x, mesh, axis_name=axis_name)
    x = rmsnorm(x.reshape(B, S, -1), params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"]).float()
