"""Context-parallel attention over a mesh dimension: ring (blockwise) and
Ulysses (head reshard).

Counterpart of ``flashinfer_tpu/parallel/ring_attention.py``, one process a
rank, each holding its sequence shard [seq / cp, heads, d] (rank i along
``axis_name`` holds tokens i * seq / cp .. (i + 1) * seq / cp).

  * ``ring_attention``: each step runs the flash kernel
    (``flash_attention_dense``, which returns o and lse) on the resident KV
    shard and merges the states (``merge_state``); the shard then moves to
    the next rank (``batch_isend_irecv``). With causal masking the block
    structure is taken per step by a Python branch, as JAX's ``lax.cond``:
    the diagonal shard runs the causal kernel, earlier shards the unmasked
    one, later shards nothing, so one kernel runs a step. The last step
    does not rotate (its shard would go unused).
  * ``ulysses_attention``: ``all_to_all`` turns the sequence shards into
    head shards, one flash call attends the whole sequence on this rank's
    heads, and a second ``all_to_all`` turns the output back.

On one rank both are one direct flash call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
)
from flashinfer_tpu_torch.ops.attention.state import merge_state
from flashinfer_tpu_torch.parallel.collectives import all_to_all
from flashinfer_tpu_torch.parallel.mesh import (
    axis_group,
    axis_peer,
    axis_rank,
    axis_size,
)

__all__ = ["ring_attention", "ulysses_attention"]


def _ppermute_next(tensors, mesh: Optional[DeviceMesh], axis_name: str):
    """Each tensor of this rank goes to the next rank along ``axis_name``
    (cyclically) and the previous rank's arrive: JAX's ``ppermute`` with
    perm j -> j + 1, as one ``batch_isend_irecv``. An identity on one
    rank."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return list(tensors)
    me = axis_rank(mesh, axis_name)
    group = axis_group(mesh, axis_name)
    nxt = axis_peer(mesh, axis_name, (me + 1) % n)
    prv = axis_peer(mesh, axis_name, (me - 1) % n)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, nxt, group=group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group=group))
        out.append(r)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Optional[DeviceMesh],
    *,
    axis_name: str = "cp",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Sequence-parallel attention around the ring of ``axis_name``.

    q/k/v: this rank's sequence shard [seq / cp, heads, d] (dimension 0
    sharded over ``axis_name``; causal needs equal q and kv shards). Returns
    this rank's rows of the output [seq / cp, hq, dv] (and lse [seq / cp,
    hq] f32 with ``return_lse``)."""
    cp = axis_size(mesh, axis_name)
    my = axis_rank(mesh, axis_name)
    if causal and q.shape[0] != k.shape[0]:
        raise ValueError("causal ring attention needs equal q/kv sharding")
    o_acc = lse_acc = None
    k_cur, v_cur = k, v
    for i in range(cp):
        src = (my - i) % cp  # the rank whose shard is resident at step i
        if not causal or src <= my:
            o, lse = flash_attention_dense(q, k_cur, v_cur,
                                           causal=causal and src == my,
                                           sm_scale=sm_scale)
            if o_acc is None:
                o_acc, lse_acc = o, lse
            else:
                o_acc, lse_acc = merge_state(o_acc, lse_acc, o, lse)
        if i < cp - 1:
            k_cur, v_cur = _ppermute_next((k_cur, v_cur), mesh, axis_name)
    return (o_acc, lse_acc) if return_lse else o_acc


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Optional[DeviceMesh],
    *,
    axis_name: str = "cp",
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Ulysses sequence parallelism: q/k/v are this rank's sequence shard
    [seq / cp, heads, d] (dimension 0 over ``axis_name``; the q and kv
    head counts divisible by cp). Returns this rank's output rows
    [seq / cp, hq, dv]."""
    cp = axis_size(mesh, axis_name)

    def to_heads(x):  # [seq / cp, h, d] -> [seq, h / cp, d]
        s, h, d = x.shape
        blocks = x.reshape(s, cp, h // cp, d).transpose(0, 1)
        return all_to_all(blocks, axis_name, mesh=mesh).reshape(
            cp * s, h // cp, d)

    def to_seq(x):  # [seq, h / cp, d] -> [seq / cp, h, d]
        s, h, d = x.shape
        back = all_to_all(x.reshape(cp, s // cp, h, d), axis_name, mesh=mesh)
        return back.transpose(0, 1).reshape(s // cp, cp * h, d)

    if cp == 1:
        return flash_attention_dense(q, k, v, causal=causal,
                                     sm_scale=sm_scale)[0]
    o, _ = flash_attention_dense(to_heads(q), to_heads(k), to_heads(v),
                                 causal=causal, sm_scale=sm_scale)
    return to_seq(o)
