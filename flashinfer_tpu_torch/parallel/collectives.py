"""Collectives with their compute, and MoE expert-parallel dispatch/combine,
on ``torch.distributed``.

Counterpart of ``flashinfer_tpu/parallel/collectives.py``. Each function is
the per-rank body of JAX's ``shard_map`` region: it takes this rank's local
tensors and reduces (or exchanges) over the process group of the mesh
dimension ``axis_name`` (``mesh.get_group(axis_name)``; ``mesh`` None is
the default group, every rank). ``psum`` is ``dist.all_reduce``,
``all_to_all`` is ``dist.all_to_all_single``; a dimension of one rank makes
the exchange an identity, as in JAX. The norms are the port's ``rmsnorm``
(the RMSNorm kernel on the card) and the fp8 quantization
``ops.fp8.fp8_quantize_rowwise``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.ops.fp8 import fp8_quantize_rowwise
from flashinfer_tpu_torch.ops.norm import fused_add_rmsnorm, rmsnorm
from flashinfer_tpu_torch.parallel.mesh import axis_group, axis_size

__all__ = [
    "all_reduce",
    "allreduce_rmsnorm",
    "allreduce_rmsnorm_quant_fp8",
    "gemm_allreduce",
    "moe_allreduce_fusion",
    "MoeAlltoAll",
]


def all_reduce(x: torch.Tensor, axis_name: str = "tp", *,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis_name`` (JAX's
    ``psum``), as a new tensor; ``x`` is not written."""
    out = x.clone()
    dist.all_reduce(out, group=axis_group(mesh, axis_name))
    return out


def all_gather(x: torch.Tensor, axis_name: str, *,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """[n, *x.shape]: ``x`` of every rank along ``axis_name``, in rank
    order (JAX's untiled ``all_gather``)."""
    n = axis_size(mesh, axis_name)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_single(out, x.contiguous(), group=axis_group(mesh, axis_name))
    return out.view((n,) + tuple(x.shape))


# the one-tensor all-gather (renamed all_gather_single in newer torch)
_gather_single = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)


def all_to_all(x: torch.Tensor, axis_name: str, *,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """x [n, ...]: block j goes to rank j along ``axis_name``; returns
    [n, ...] with block i from rank i (JAX's tiled ``all_to_all`` over the
    leading axis). An identity on one rank."""
    if axis_size(mesh, axis_name) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis_group(mesh, axis_name))
    return out


def gemm_allreduce(x: torch.Tensor, w: torch.Tensor, axis_name: str = "tp",
                   *, out_dtype: Optional[torch.dtype] = None,
                   mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Row-parallel GEMM then the all-reduce: x [m, k_local] @ w [k_local,
    n] accumulated in f32, summed over the ranks, cast to ``out_dtype``
    (x's by default)."""
    acc = all_reduce(x.float() @ w.float(), axis_name, mesh=mesh)
    return acc.to(out_dtype or x.dtype)


def allreduce_rmsnorm(
    x: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    axis_name: str = "tp",
    *,
    mesh: Optional[DeviceMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce, residual add, RMSNorm. Returns (normed, new_residual):
    new_residual = sum(x) + residual, added in f32 and rounded once to the
    residual's dtype (JAX rounds to x's; the two agree where x and the
    residual share a dtype). Where they and the weight share one, the add
    and the norm are one fused launch on the card."""
    full = all_reduce(x, axis_name, mesh=mesh)
    if full.dtype == residual.dtype == weight.dtype:
        return fused_add_rmsnorm(full, residual, weight, eps)
    new_residual = (full.float() + residual.float()).to(residual.dtype)
    return rmsnorm(new_residual, weight.to(new_residual.dtype),
                   eps), new_residual


def allreduce_rmsnorm_quant_fp8(
    x: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    axis_name: str = "tp",
    *,
    mesh: Optional[DeviceMesh] = None,
):
    """``allreduce_rmsnorm`` then per-row e4m3 quantization of the normed
    rows. Returns (q float8_e4m3fn, scale [rows] f32, new_residual)."""
    normed, new_residual = allreduce_rmsnorm(x, residual, weight, eps,
                                             axis_name, mesh=mesh)
    q, scale = fp8_quantize_rowwise(normed)
    return q, scale, new_residual


def moe_allreduce_fusion(
    moe_out: torch.Tensor,
    scale,
    shared_out: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    axis_name: str = "tp",
    *,
    mesh: Optional[DeviceMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE finalize: new_residual = sum(moe_out * scale) + shared_out +
    residual in f32, rounded to moe_out's dtype; returns
    (rmsnorm(new_residual), new_residual)."""
    contrib = moe_out.float() * scale
    full = all_reduce(contrib, axis_name, mesh=mesh)
    new_residual = (full + shared_out.float()
                    + residual.float()).to(moe_out.dtype)
    return (rmsnorm(new_residual, weight.to(new_residual.dtype), eps),
            new_residual)


class MoeAlltoAll:
    """Expert-parallel dispatch/combine over the mesh dimension
    ``axis_name`` (JAX's ``MoeAlltoAll``).

    Capacity-based: a rank sends at most ``capacity`` token copies to each
    peer a call (fixed shapes). A copy's slot in its destination's buffer is
    the count of earlier copies (token-major, then top-k) bound there; a
    copy past the capacity is dropped (slot -1) and contributes nothing to
    the combine. ``dispatch`` sends each copy to the rank holding its expert
    (expert e on rank e // (num_experts / ep)); ``combine`` brings the
    results back and sums the top-k contributions by their scales.
    """

    def __init__(self, num_experts: int, capacity: int, axis_name: str = "ep",
                 *, mesh: Optional[DeviceMesh] = None):
        self.num_experts = num_experts
        self.capacity = capacity
        self.axis_name = axis_name
        self.mesh = mesh

    def _ep(self) -> int:
        return axis_size(self.mesh, self.axis_name)

    def dispatch(self, x: torch.Tensor, expert_ids: torch.Tensor):
        """x [local_tokens, hidden], expert_ids [local_tokens, top_k] (global
        ids). Returns (recv_x [ep * capacity, hidden], recv_expert
        [ep * capacity] (-1 in an empty slot), send_slot [local_tokens,
        top_k]: the slot each copy took at its destination, -1 if
        dropped)."""
        ep, cap = self._ep(), self.capacity
        eper = self.num_experts // ep
        m, top_k = expert_ids.shape
        hidden = x.shape[1]
        flat_ids = expert_ids.reshape(-1).long()
        dest = flat_ids // eper
        onehot = F.one_hot(dest, ep)
        slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1)
        keep = slot < cap
        slot = torch.where(keep, slot, -1)
        # dropped copies go to a spare row and column that is cut off, so
        # they never overwrite a kept copy (JAX's scatter mode="drop")
        d_idx = torch.where(keep, dest, ep)
        s_idx = torch.where(keep, slot, cap)
        tok = torch.arange(m * top_k, device=x.device) // top_k
        send_x = x.new_zeros(ep + 1, cap + 1, hidden)
        send_e = torch.full((ep + 1, cap + 1), -1, dtype=torch.int32,
                            device=x.device)
        send_x[d_idx, s_idx] = x[tok]
        send_e[d_idx, s_idx] = flat_ids.to(torch.int32)
        recv_x = all_to_all(send_x[:ep, :cap], self.axis_name,
                            mesh=self.mesh)
        recv_e = all_to_all(send_e[:ep, :cap], self.axis_name,
                            mesh=self.mesh)
        return (recv_x.reshape(ep * cap, hidden), recv_e.reshape(-1),
                slot.reshape(m, top_k))

    def combine(self, y: torch.Tensor, send_slot: torch.Tensor,
                expert_ids: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
        """y [ep * capacity, hidden]: the processed copies, in ``dispatch``'s
        receive order. Returns [local_tokens, hidden] in y's dtype: each
        token's kept copies times their scales, summed in f32."""
        ep, cap = self._ep(), self.capacity
        eper = self.num_experts // ep
        hidden = y.shape[1]
        back = all_to_all(y.reshape(ep, cap, hidden), self.axis_name,
                          mesh=self.mesh)  # slot s sent to rank d: [d, s]
        dest = expert_ids.long() // eper
        valid = send_slot >= 0
        d_idx = torch.where(valid, dest, 0)
        s_idx = torch.where(valid, send_slot, 0).long()
        gathered = torch.where(valid[..., None], back[d_idx, s_idx], 0)
        return (gathered.float() * scales.float()[..., None]).sum(
            dim=1).to(y.dtype)
