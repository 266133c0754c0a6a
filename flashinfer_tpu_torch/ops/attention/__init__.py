from flashinfer_tpu_torch.ops.attention.batch import (
    BatchAttention,
    BatchDecodeWithPagedKVCacheWrapper,
    BatchPrefillWithPagedKVCacheWrapper,
    DevicePlan,
    PlanMeta,
    run_device_plan,
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
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.state import gather_merge_states

__all__ = [
    "BatchAttention",
    "BatchDecodeWithPagedKVCacheWrapper",
    "BatchMLAPagedAttentionWrapper",
    "BatchPrefillWithPagedKVCacheWrapper",
    "DevicePlan",
    "PlanMeta",
    "attention_reference",
    "batch_paged_attention_run",
    "gather_merge_states",
    "mla_paged_plain",
    "mla_paged_run",
    "paged_attention_plain",
    "run_device_plan",
]
