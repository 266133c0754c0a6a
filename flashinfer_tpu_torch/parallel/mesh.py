"""A ``Mapping`` as ``torch.distributed`` device meshes, and the canonical
partition specs.

Counterpart of ``flashinfer_tpu/parallel/mesh.py``. One process runs each
rank and holds that rank's shard of every tensor. Two mesh views share the
same ranks, row-major as in the JAX package (rank r is device r):

  * attention/dense view: dimensions (dp, pp, cp, tp)
  * MoE view:             dimensions (dp, pp, ep, moe_tp), the (cp x tp)
    sub-grid refactored as ``Mapping``'s MoE groups.

A partition spec is a tuple with one entry a tensor dimension: None
(replicated), a mesh dimension's name, or a tuple of names (the dimension
split over their product, the first name outermost): the values of JAX's
``PartitionSpec``s. ``local_shard`` slices a rank's shard of a full tensor
(or numpy array) from such a spec. The parallel entry points take and
return local shards; each axis's process group comes from
``mesh.get_group(name)`` and carries the collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.parallel.mapping import Mapping

__all__ = ["make_mesh", "MeshContext", "shard_model_specs",
           "shard_kv_cache_spec"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """Ranks along the mesh dimension ``name`` (None: the whole world)."""
    if mesh is None:
        return dist.get_world_size()
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along the mesh dimension ``name``."""
    if mesh is None:
        return dist.get_rank()
    return mesh.get_local_rank(name)


def axis_group(mesh: Optional[DeviceMesh], name: str):
    """The process group along ``name`` through this rank (None: the
    default group, every rank)."""
    if mesh is None:
        return dist.group.WORLD
    return mesh.get_group(name)


def axis_peer(mesh: Optional[DeviceMesh], name: str, index: int) -> int:
    """The global rank at coordinate ``index`` along ``name`` in this
    rank's group (for point-to-point calls)."""
    return dist.get_process_group_ranks(axis_group(mesh, name))[index]


def local_shard(t, spec: Spec, mesh: Optional[DeviceMesh]):
    """This rank's shard of the full tensor or numpy array ``t`` under
    ``spec`` (one entry a dimension; a missing trailing entry is
    replicated): a view, no copy. A dimension split over several mesh
    dimensions takes them in order, the first outermost, as JAX does."""
    idx = [slice(None)] * t.ndim
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        n, pos = 1, 0
        for name in names:
            size = axis_size(mesh, name)
            pos = pos * size + axis_rank(mesh, name)
            n *= size
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {names} ({n} ranks)")
        step = t.shape[dim] // n
        idx[dim] = slice(pos * step, (pos + 1) * step)
    return t[tuple(idx)]


@dataclasses.dataclass
class MeshContext:
    """The two views of a ``Mapping``'s ranks. ``sharding(*spec)`` /
    ``moe_sharding(*spec)`` give the function that takes a full tensor to
    this rank's shard under the view (JAX's ``NamedSharding``)."""

    mapping: Mapping
    mesh: DeviceMesh  # (dp, pp, cp, tp)
    moe_mesh: DeviceMesh  # (dp, pp, ep, moe_tp)

    def sharding(self, *spec):
        return lambda t: local_shard(t, spec, self.mesh)

    def moe_sharding(self, *spec):
        return lambda t: local_shard(t, spec, self.moe_mesh)


def make_mesh(mapping: Mapping,
              device_type: Optional[str] = None) -> MeshContext:
    """The mesh views of ``mapping`` over the process group's first
    ``mapping.world_size`` ranks, row-major (dp, pp, cp, tp), so rank r is
    device r. Needs an initialised process group
    (``serving.distributed.bootstrap_distributed``); ``device_type``
    defaults to "cuda" on an NCCL group, else "cpu". Every rank of the
    world calls it (each view creates the process groups of its
    dimensions)."""
    if dist.get_world_size() < mapping.world_size:
        raise ValueError(f"need {mapping.world_size} ranks, have "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(mapping.world_size)
    m = mapping
    mesh = DeviceMesh(device_type,
                      grid.reshape(m.dp_size, m.pp_size, m.cp_size,
                                   m.tp_size),
                      mesh_dim_names=("dp", "pp", "cp", "tp"))
    moe_mesh = DeviceMesh(device_type,
                          grid.reshape(m.dp_size, m.pp_size, m.moe_ep_size,
                                       m.moe_tp_size),
                          mesh_dim_names=("dp", "pp", "ep", "moe_tp"))
    return MeshContext(mapping=mapping, mesh=mesh, moe_mesh=moe_mesh)


def shard_model_specs(hidden_axis: str = "tp") -> Dict[str, Spec]:
    """Megatron-style specs of a transformer block: column-parallel
    up/qkv projections, row-parallel down/output projections (JAX's
    values)."""
    return {
        "embedding": (None, hidden_axis),
        "wq": (None, hidden_axis),
        "wk": (None, hidden_axis),
        "wv": (None, hidden_axis),
        "wo": (hidden_axis, None),
        "w_gate_up": (None, hidden_axis),
        "w_down": (hidden_axis, None),
        "norm": (None,),
        "lm_head": (None, hidden_axis),
        # MoE expert weights: experts over ep, hidden over moe_tp
        "moe_w1": ("ep", None, "moe_tp"),
        "moe_w2": ("ep", "moe_tp", None),
    }


def shard_kv_cache_spec() -> Spec:
    """Paged KV cache [pages, kvh, page_size, d]: heads over tp, pages
    replicated within the tp group."""
    return (None, "tp", None, None)
