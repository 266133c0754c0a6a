from flashinfer_tpu_torch.models.deepseek import (
    DeepSeekConfig,
    deepseek_decode_step,
    deepseek_forward_dense,
    deepseek_init_weights,
)
from flashinfer_tpu_torch.models.llama import (
    LlamaConfig,
    llama_decode_step,
    llama_forward_dense,
    llama_init_weights,
    llama_init_weights_fp8,
    llama_init_weights_int8,
    params_from_numpy,
    quantize_llama_weights_fp8,
    quantize_llama_weights_int8,
)

__all__ = ["DeepSeekConfig", "LlamaConfig", "deepseek_decode_step",
           "deepseek_forward_dense", "deepseek_init_weights",
           "llama_decode_step", "llama_forward_dense", "llama_init_weights",
           "llama_init_weights_fp8", "llama_init_weights_int8",
           "params_from_numpy", "quantize_llama_weights_fp8",
           "quantize_llama_weights_int8"]
