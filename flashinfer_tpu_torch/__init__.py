"""flashinfer_tpu_torch: the PyTorch/CUDA port of flashinfer_tpu for one
NVIDIA H100.

Entry points run on the card by default; pass ``device="cpu"`` to run every
kernel's plain PyTorch version instead. The CUDA kernels build with nvcc at
first use (``flashinfer_tpu_torch.jit``)."""

from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops.attention.pod import PODWithPagedKVCacheWrapper
from flashinfer_tpu_torch.ops.attention.single import (
    single_decode_with_kv_cache,
    single_prefill_with_kv_cache,
)
from flashinfer_tpu_torch.ops.norm import (
    fused_add_rmsnorm,
    gemma_fused_add_rmsnorm,
    gemma_rmsnorm,
    rmsnorm,
)
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    LlamaServingEngine,
)

__all__ = ["EngineConfig", "GenerationRequest", "LlamaConfig",
           "LlamaServingEngine", "PODWithPagedKVCacheWrapper",
           "fused_add_rmsnorm", "gemma_fused_add_rmsnorm", "gemma_rmsnorm",
           "params_from_numpy", "rmsnorm", "single_decode_with_kv_cache",
           "single_prefill_with_kv_cache"]
