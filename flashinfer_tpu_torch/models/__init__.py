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
    params_from_numpy,
)

__all__ = ["DeepSeekConfig", "LlamaConfig", "deepseek_decode_step",
           "deepseek_forward_dense", "deepseek_init_weights",
           "llama_decode_step", "llama_forward_dense", "llama_init_weights",
           "params_from_numpy"]
