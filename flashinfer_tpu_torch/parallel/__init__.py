"""The distributed layer on ``torch.distributed``: topology math, device
meshes, collectives, ring / Ulysses attention, sharded MoE, pipeline and
tensor-parallel serving (counterpart of ``flashinfer_tpu/parallel``).

One process a rank, each holding its shards; a JAX ``shard_map`` body is
the per-rank function, and each mesh dimension's process group
(``DeviceMesh.get_group(name)``) carries its collectives. See
``parallel/mesh.py`` for the spec convention."""

from flashinfer_tpu_torch.parallel.collectives import (
    MoeAlltoAll,
    all_reduce,
    allreduce_rmsnorm,
    allreduce_rmsnorm_quant_fp8,
    gemm_allreduce,
    moe_allreduce_fusion,
)
from flashinfer_tpu_torch.parallel.mapping import Mapping
from flashinfer_tpu_torch.parallel.moe import (
    fused_moe_ep,
    fused_moe_tp,
    moe_ep_capacity,
)
from flashinfer_tpu_torch.parallel.pipeline import (
    llama_forward_pipelined,
    pipeline_forward,
)
from flashinfer_tpu_torch.parallel.mesh import (
    MeshContext,
    make_mesh,
    shard_kv_cache_spec,
    shard_model_specs,
)
from flashinfer_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from flashinfer_tpu_torch.parallel.tp_serving import (
    make_tp_decode_step,
    shard_llama_params_tp,
    tp_param_specs,
)

__all__ = [
    "Mapping",
    "MeshContext",
    "fused_moe_ep",
    "fused_moe_tp",
    "moe_ep_capacity",
    "llama_forward_pipelined",
    "pipeline_forward",
    "make_mesh",
    "shard_model_specs",
    "shard_kv_cache_spec",
    "all_reduce",
    "allreduce_rmsnorm",
    "allreduce_rmsnorm_quant_fp8",
    "gemm_allreduce",
    "moe_allreduce_fusion",
    "MoeAlltoAll",
    "ring_attention",
    "ulysses_attention",
    "make_tp_decode_step",
    "shard_llama_params_tp",
    "tp_param_specs",
]
