"""flashinfer_tpu_torch: the PyTorch/CUDA port of flashinfer_tpu for one
NVIDIA H100.

Entry points run on the card by default; pass ``device="cpu"`` to run every
kernel's plain PyTorch version instead. The CUDA kernels build with nvcc at
first use (``flashinfer_tpu_torch.jit``).

``__all__`` holds the names of the JAX package's ``__all__``, all of which
the port computes. The Llama serving engine, the model configurations, the
op modules and the subsystem namespaces (``aot``, ``autotuner``, ``jit``,
``logits_processor``, ``models``, ``profiler``, ``scheduler``, ``serving``,
``testing``, ``parallel``) are attributes here too, as in the JAX package,
outside ``__all__``."""

__version__ = "0.1.0"  # the JAX package's version, which the port tracks

from flashinfer_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    params_from_numpy,
)
import importlib as _importlib

from flashinfer_tpu_torch.ops import (  # noqa: F401
    activation,
    fp4,
    fp8,
    gemm,
    norm,
    quantization,
    rope,
    sampling,
)
from flashinfer_tpu_torch.ops.activation import (
    gelu_and_mul,
    gelu_tanh_and_mul,
    silu_and_mul,
)
from flashinfer_tpu_torch.ops.attention.batch import (
    BatchAttention,
    BatchAttentionWithAttentionSinkWrapper,
    BatchDecodeWithPagedKVCacheWrapper,
    BatchPrefillWithPagedKVCacheWrapper,
    BatchPrefillWithRaggedKVCacheWrapper,
)
from flashinfer_tpu_torch.ops.attention.cascade import (
    MultiLevelCascadeAttentionWrapper,
)
from flashinfer_tpu_torch.ops.attention.mla import (
    BatchMLAPagedAttentionWrapper,
)
from flashinfer_tpu_torch.ops.attention.pod import PODWithPagedKVCacheWrapper
from flashinfer_tpu_torch.ops.attention.single import (
    single_decode_with_kv_cache,
    single_prefill_with_kv_cache,
)
from flashinfer_tpu_torch.ops.attention.sparse import (
    BlockSparseAttentionWrapper,
    VariableBlockSparseAttentionWrapper,
)
from flashinfer_tpu_torch.ops.attention.state import (
    merge_state,
    merge_state_in_place,
    merge_states,
    variable_length_merge_states,
)
from flashinfer_tpu_torch.ops.attention.variants import (
    AttentionVariant,
    DefaultAttention,
    FlashSigmoid,
    make_default_variant,
)
from flashinfer_tpu_torch.ops.gemm import (
    SegmentGEMMWrapper,
    bmm_fp8,
    gemm_fp8_nt_groupwise,
    group_gemm_fp8_nt_groupwise,
    mm_fp4,
)
from flashinfer_tpu_torch.ops.norm import (
    fused_add_rmsnorm,
    gemma_fused_add_rmsnorm,
    gemma_rmsnorm,
    rmsnorm,
)
from flashinfer_tpu_torch.ops.page import (
    append_paged_kv_cache,
    append_paged_mla_kv_cache,
    block_sparse_indices_to_vector_sparse_offsets,
    get_batch_indices_positions,
    get_seq_lens,
)
from flashinfer_tpu_torch.ops.quantization import packbits, segment_packbits
from flashinfer_tpu_torch.ops.rope import (
    apply_llama31_rope,
    apply_llama31_rope_pos_ids,
    apply_rope,
    apply_rope_pos_ids,
    apply_rope_with_cos_sin_cache,
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
from flashinfer_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    GenerationRequest,
    LlamaServingEngine,
    propose_ngram,
)
from flashinfer_tpu_torch.utils import MaskMode, PosEncodingMode, TensorLayout

# the module, as in the JAX package (``ops.fused_moe`` is the function)
fused_moe = _importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")
del _importlib

from flashinfer_tpu_torch import (  # noqa: F401, E402 (subsystem namespaces)
    aot,
    autotuner,
    jit,
    logits_processor,
    models,
    parallel,
    profiler,
    scheduler,
    serving,
    testing,
)

__all__ = [
    "__version__",
    "MaskMode",
    "PosEncodingMode",
    "TensorLayout",
    # attention
    "BatchAttention",
    "BatchAttentionWithAttentionSinkWrapper",
    "BatchDecodeWithPagedKVCacheWrapper",
    "BatchPrefillWithPagedKVCacheWrapper",
    "BatchPrefillWithRaggedKVCacheWrapper",
    "BatchMLAPagedAttentionWrapper",
    "BlockSparseAttentionWrapper",
    "VariableBlockSparseAttentionWrapper",
    "MultiLevelCascadeAttentionWrapper",
    "PODWithPagedKVCacheWrapper",
    "single_prefill_with_kv_cache",
    "single_decode_with_kv_cache",
    "AttentionVariant",
    "DefaultAttention",
    "FlashSigmoid",
    "make_default_variant",
    "merge_state",
    "merge_state_in_place",
    "merge_states",
    "variable_length_merge_states",
    # page
    "append_paged_kv_cache",
    "append_paged_mla_kv_cache",
    "get_batch_indices_positions",
    "get_seq_lens",
    "block_sparse_indices_to_vector_sparse_offsets",
    # ops
    "silu_and_mul",
    "gelu_and_mul",
    "gelu_tanh_and_mul",
    "rmsnorm",
    "fused_add_rmsnorm",
    "gemma_rmsnorm",
    "gemma_fused_add_rmsnorm",
    "apply_rope",
    "apply_rope_pos_ids",
    "apply_llama31_rope",
    "apply_llama31_rope_pos_ids",
    "apply_rope_with_cos_sin_cache",
    "packbits",
    "segment_packbits",
    "SegmentGEMMWrapper",
    "bmm_fp8",
    "mm_fp4",
    "gemm_fp8_nt_groupwise",
    "group_gemm_fp8_nt_groupwise",
    # sampling
    "softmax",
    "sampling_from_probs",
    "sampling_from_logits",
    "top_p_sampling_from_probs",
    "top_k_sampling_from_probs",
    "min_p_sampling_from_probs",
    "top_k_top_p_sampling_from_probs",
    "top_k_top_p_sampling_from_logits",
    "top_p_renorm_probs",
    "top_k_renorm_probs",
    "top_k_mask_logits",
    "chain_speculative_sampling",
]
