"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Role of ``flashinfer_tpu/jit/core.py`` for the port. Each source in
``flashinfer_tpu_torch/csrc/*.cu`` becomes one shared library with a plain C
interface, built at first use for ``sm_90a`` into ``flashinfer_tpu_torch/_build``
(listed in .gitignore), keyed by a hash of the source, the headers and the
flags, and guarded by an O_EXCL lock file so concurrent processes build once.
``build_all`` starts one nvcc per source, all at once.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["KERNEL_SOURCES", "build_all", "load", "check", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("paged_attention", "sampling", "mla_attention",
                  "grouped_gemm", "flash_attention", "norm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LOCK_STALE_SECONDS = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and shared-memory report) from
    the build of ``name``, or '' if it was built by another process."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _take_lock(lock: Path) -> bool:
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        try:
            if time.time() - lock.stat().st_mtime > _LOCK_STALE_SECONDS:
                lock.unlink()
        except FileNotFoundError:
            pass
        return False


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every named library that is not built yet, one nvcc process per
    source, all started together. Returns seconds spent per built name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending: List[str] = [n for n in names if not _lib_path(n).exists()]
    procs = {}
    t0 = time.time()
    waiting: List[str] = []
    for name in pending:
        lib = _lib_path(name)
        lock = lib.with_suffix(".lock")
        if not _take_lock(lock):
            waiting.append(name)
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
               str(CSRC_DIR / f"{name}.cu"), "-o", str(lib) + ".tmp"]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lock)
    seconds: Dict[str, float] = {}
    errors = []
    for name, (proc, lock) in procs.items():
        try:
            out, _ = proc.communicate()
            lib = _lib_path(name)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            lib.with_suffix(".log").write_text(out)
            os.replace(str(lib) + ".tmp", lib)
            seconds[name] = time.time() - t0
        finally:
            lock.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in waiting:  # another process holds the lock: wait for its .so
        lib = _lib_path(name)
        lock = lib.with_suffix(".lock")
        while not lib.exists():
            if not lock.exists():  # that build failed or was abandoned
                seconds.update(build_all([name]))
                break
            time.sleep(0.2)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
