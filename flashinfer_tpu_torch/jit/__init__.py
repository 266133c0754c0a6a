"""The port's native-code layer (counterpart of ``flashinfer_tpu/jit/``):
the CUDA kernels built with nvcc and the host runtime (C++ planner and page
pool) built with the system C++ compiler, both at first use. See core.py."""

from flashinfer_tpu_torch.jit.core import (
    KERNEL_SOURCES,
    JitSpec,
    _lib_path,
    _nvcc,
    build_all,
    build_and_load,
    build_log,
    check,
    clear_cache,
    get_native_runtime,
    jit_registry,
    load,
)
from flashinfer_tpu_torch.jit.env import CACHE_DIR, logger

__all__ = [
    "KERNEL_SOURCES",
    "build_all",
    "load",
    "check",
    "build_log",
    "JitSpec",
    "build_and_load",
    "clear_cache",
    "get_native_runtime",
    "jit_registry",
    "CACHE_DIR",
    "logger",
]
