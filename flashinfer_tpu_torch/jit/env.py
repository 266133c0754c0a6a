"""Environment of the port's build layer (counterpart of
``flashinfer_tpu/jit/env.py``).

Environment variables, the JAX package's names:
  FLASHINFER_TPU_CACHE_DIR   build directory of the nvcc libraries and the
                             host runtime (default ``flashinfer_tpu_torch/_build``)
  FLASHINFER_TPU_CXX         C++ compiler of the host runtime (default g++)
  FLASHINFER_TPU_CXXFLAGS    extra flags for it
  FLASHINFER_TPU_PLANNER     "native" | "numpy" | "auto" (default auto:
                             native when the host runtime builds)
  FLASHINFER_TPU_LOG_LEVEL   Python logging level name (default WARNING)

JAX's ``FLASHINFER_TPU_INTERPRET`` switches Pallas's interpreter; the port
has none (a CPU tensor takes each kernel's plain version), so it is not read.
"""

from __future__ import annotations

import logging
import os
import pathlib

__all__ = [
    "CACHE_DIR",
    "NATIVE_BUILD_DIR",
    "CSRC_DIR",
    "HOST_CSRC_DIR",
    "cxx",
    "cxxflags",
    "planner_backend",
    "logger",
]

_PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CACHE_DIR = pathlib.Path(
    os.environ.get("FLASHINFER_TPU_CACHE_DIR", str(_PACKAGE_DIR / "_build")))
# the host runtime's library lands beside the kernels' (JAX keeps it in a
# subdirectory of its cache, flashinfer_tpu/jit/env.py:40)
NATIVE_BUILD_DIR = CACHE_DIR
CSRC_DIR = _PACKAGE_DIR / "csrc"  # the CUDA kernels (*.cu, *.cuh)
HOST_CSRC_DIR = CSRC_DIR / "host"  # the host runtime (*.cc, *.h)


def cxx() -> str:
    return os.environ.get("FLASHINFER_TPU_CXX", "g++")


def cxxflags() -> list[str]:
    base = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]
    extra = os.environ.get("FLASHINFER_TPU_CXXFLAGS", "")
    return base + extra.split()


def planner_backend() -> str:
    v = os.environ.get("FLASHINFER_TPU_PLANNER", "auto").lower()
    if v not in ("native", "numpy", "auto"):
        raise ValueError(
            f"FLASHINFER_TPU_PLANNER={v!r} not in native|numpy|auto")
    return v


def _make_logger() -> logging.Logger:
    log = logging.getLogger("flashinfer_tpu_torch")
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [flashinfer_tpu_torch] %(levelname)s %(message)s"))
        log.addHandler(handler)
    log.setLevel(os.environ.get("FLASHINFER_TPU_LOG_LEVEL", "WARNING").upper())
    return log


logger = _make_logger()
