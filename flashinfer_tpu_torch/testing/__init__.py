"""Testing and benchmarking helpers (counterpart of
``flashinfer_tpu/testing/``)."""

from flashinfer_tpu_torch.testing.utils import (
    assert_close_with_mismatch_tolerance,
    attention_bytes,
    attention_flops,
    attention_tb_per_sec,
    attention_tflops_per_sec,
    bench_gpu_time,
    bench_gpu_time_differential,
    gemm_flops,
    quantize_fp8_rowwise_ref,
)

__all__ = [
    "assert_close_with_mismatch_tolerance",
    "attention_bytes",
    "attention_flops",
    "attention_tb_per_sec",
    "attention_tflops_per_sec",
    "bench_gpu_time",
    "bench_gpu_time_differential",
    "gemm_flops",
    "quantize_fp8_rowwise_ref",
]
