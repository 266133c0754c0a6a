from flashinfer_tpu_torch.scheduler.native import PagePool
from flashinfer_tpu_torch.scheduler.plan import (
    AttentionPlan,
    build_merge_src,
    kv_major_order,
    plan_attention,
    plan_decode,
    plan_prefill,
)

__all__ = [
    "AttentionPlan",
    "PagePool",
    "build_merge_src",
    "kv_major_order",
    "plan_attention",
    "plan_decode",
    "plan_prefill",
]
