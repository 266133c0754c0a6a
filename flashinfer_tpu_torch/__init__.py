"""flashinfer_tpu_torch: the PyTorch/CUDA port of flashinfer_tpu for one
NVIDIA H100.

Entry points run on the card by default; pass ``device="cpu"`` to run every
kernel's plain PyTorch version instead. The CUDA kernels build with nvcc at
first use (``flashinfer_tpu_torch.jit``)."""

from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops import fp4, fp8, gemm
from flashinfer_tpu_torch.ops.gemm import (
    SegmentGEMMWrapper,
    bmm_fp8,
    gemm_fp8_nt_groupwise,
    group_gemm_fp8_nt_groupwise,
    mm_fp4,
)
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
from flashinfer_tpu_torch.ops.sampling import (
    chain_speculative_sampling,
    min_p_sampling_from_probs,
    sampling_from_logits,
    sampling_from_probs,
    softmax,
    top_k_mask_logits,
    top_k_renorm_probs,
    top_k_sampling_from_probs,
    top_k_top_p_sampling_from_logits,
    top_k_top_p_sampling_from_probs,
    top_p_renorm_probs,
    top_p_sampling_from_probs,
)
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    LlamaServingEngine,
    propose_ngram,
)

__all__ = ["EngineConfig", "GenerationRequest", "LlamaConfig",
           "LlamaServingEngine", "PODWithPagedKVCacheWrapper",
           "SegmentGEMMWrapper", "bmm_fp8", "chain_speculative_sampling",
           "fp4", "fp8", "fused_add_rmsnorm", "gemm", "gemm_fp8_nt_groupwise",
           "gemma_fused_add_rmsnorm", "gemma_rmsnorm",
           "group_gemm_fp8_nt_groupwise", "min_p_sampling_from_probs",
           "mm_fp4", "params_from_numpy", "propose_ngram",
           "rmsnorm", "sampling_from_logits", "sampling_from_probs",
           "single_decode_with_kv_cache", "single_prefill_with_kv_cache",
           "softmax", "top_k_mask_logits", "top_k_renorm_probs",
           "top_k_sampling_from_probs", "top_k_top_p_sampling_from_logits",
           "top_k_top_p_sampling_from_probs", "top_p_renorm_probs",
           "top_p_sampling_from_probs"]
