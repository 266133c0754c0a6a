from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    LlamaServingEngine,
    calibrate_kv_scales,
    fuse_qkv_weights,
    propose_ngram,
)

__all__ = ["EngineConfig", "GenerationRequest", "LlamaServingEngine",
           "calibrate_kv_scales", "fuse_qkv_weights", "propose_ngram"]
