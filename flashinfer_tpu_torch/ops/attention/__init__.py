from flashinfer_tpu_torch.ops.attention.batch import (
    BatchAttention,
    BatchDecodeWithPagedKVCacheWrapper,
    BatchPrefillWithPagedKVCacheWrapper,
    DevicePlan,
    PlanMeta,
    run_device_plan,
)
from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
    flash_attention_plain,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
    paged_attention_plain,
)
from flashinfer_tpu_torch.ops.attention.mla import (
    BatchMLAPagedAttentionWrapper,
    mla_paged_plain,
    mla_paged_run,
)
from flashinfer_tpu_torch.ops.attention.pod import PODWithPagedKVCacheWrapper
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.single import (
    default_alibi_slopes,
    single_decode_with_kv_cache,
    single_prefill_with_kv_cache,
)
from flashinfer_tpu_torch.ops.attention.state import (
    gather_merge_states,
    merge_state,
    merge_states,
)
from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    DefaultAttention,
    FlashSigmoid,
    make_default_variant,
)

__all__ = [
    "AttentionVariant",
    "BatchAttention",
    "BatchDecodeWithPagedKVCacheWrapper",
    "BatchMLAPagedAttentionWrapper",
    "BatchPrefillWithPagedKVCacheWrapper",
    "DefaultAttention",
    "DevicePlan",
    "FlashSigmoid",
    "PODWithPagedKVCacheWrapper",
    "PlanMeta",
    "attention_reference",
    "batch_paged_attention_run",
    "default_alibi_slopes",
    "flash_attention_dense",
    "flash_attention_plain",
    "gather_merge_states",
    "make_default_variant",
    "merge_state",
    "merge_states",
    "mla_paged_plain",
    "mla_paged_run",
    "paged_attention_plain",
    "run_device_plan",
    "single_decode_with_kv_cache",
    "single_prefill_with_kv_cache",
]
