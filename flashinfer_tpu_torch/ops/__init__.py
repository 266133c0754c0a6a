from flashinfer_tpu_torch.ops.activation import gelu_and_mul, silu_and_mul
from flashinfer_tpu_torch.ops.fused_moe import (
    GatedActType,
    RoutingMethodType,
    fused_moe,
    route_tokens,
)
from flashinfer_tpu_torch.ops.gemm_grouped import (
    GroupLayout,
    grouped_gemm,
    grouped_gemm_padded,
    make_group_layout,
)
from flashinfer_tpu_torch.ops.norm import (
    fused_add_rmsnorm,
    fused_add_rmsnorm_plain,
    gemma_fused_add_rmsnorm,
    gemma_rmsnorm,
    rmsnorm,
    rmsnorm_plain,
)
from flashinfer_tpu_torch.ops.quantization import (
    packbits,
    segment_packbits,
    unpackbits,
)
from flashinfer_tpu_torch.ops.page import (
    append_paged_kv_cache,
    append_paged_mla_kv_cache,
    get_batch_indices_positions,
    get_seq_lens,
)
from flashinfer_tpu_torch.ops.rope import (
    apply_rope_pos_ids,
    mla_rope_quantize_fp8,
    rope_cos_sin_cache,
)
from flashinfer_tpu_torch.ops.sampling import (
    family_call,
    family_plain,
    softmax,
    top_k_top_p_sampling_from_probs,
)

__all__ = [
    "GatedActType",
    "GroupLayout",
    "RoutingMethodType",
    "append_paged_kv_cache",
    "append_paged_mla_kv_cache",
    "apply_rope_pos_ids",
    "family_call",
    "family_plain",
    "fused_add_rmsnorm",
    "fused_add_rmsnorm_plain",
    "fused_moe",
    "gelu_and_mul",
    "gemma_fused_add_rmsnorm",
    "gemma_rmsnorm",
    "get_batch_indices_positions",
    "get_seq_lens",
    "grouped_gemm",
    "grouped_gemm_padded",
    "make_group_layout",
    "mla_rope_quantize_fp8",
    "packbits",
    "rmsnorm",
    "rmsnorm_plain",
    "rope_cos_sin_cache",
    "route_tokens",
    "segment_packbits",
    "silu_and_mul",
    "softmax",
    "top_k_top_p_sampling_from_probs",
    "unpackbits",
]
