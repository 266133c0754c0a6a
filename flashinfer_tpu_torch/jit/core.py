"""Build the port's native code at first use, cache it on disk, load it.

Counterpart of ``flashinfer_tpu/jit/core.py``. Two kinds of library, each
keyed by a hash of its sources, its headers and its flags, each guarded by
an O_EXCL lock file so concurrent processes build once:

* the CUDA kernels: each ``csrc/<name>.cu`` becomes one shared library with
  a plain C interface, built with nvcc for ``sm_90a`` (``build_all`` starts
  one nvcc per source, all at once; ``load`` returns one). Every C entry
  point returns ``cudaGetLastError()``; ``check`` raises on a non-zero code,
  so a refused launch never passes silently. The hash reads ``csrc/*.cuh``
  and the ``.cu`` files a source includes (``paged_attention_gather.cu``
  is ``paged_attention.cu`` built again with ``FI_PAGED_GATHER``).
* the host runtime (``csrc/host/``: the C++ planner and page pool, a copy
  of the JAX package's ``csrc/``), built with the system C++ compiler as a
  ``JitSpec`` (``build_and_load``; ``get_native_runtime`` loads it and
  checks its ABI). The hash reads ``csrc/host/*.h``.

A caller's attention variant adds a third kind: ``jit/variant.py`` traces
its hooks into a generated header, and the flash or paged kernel is built
again with ``-DFI_USER_VARIANT -include <header>``; that library is keyed by
the header too (its leaves' dtypes are part of it). A target is a kernel
name, or a (name, header path) pair for such a build.

All land in ``env.CACHE_DIR`` (``flashinfer_tpu_torch/_build`` unless
``FLASHINFER_TPU_CACHE_DIR`` says otherwise); ``jit_registry`` records
every build and load of either kind.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from flashinfer_tpu_torch.jit.env import (
    CACHE_DIR,
    CSRC_DIR,
    HOST_CSRC_DIR,
    NATIVE_BUILD_DIR,
    cxx,
    cxxflags,
    logger,
)

__all__ = [
    "KERNEL_SOURCES",
    "build_all",
    "load",
    "check",
    "build_log",
    "JitSpec",
    "build_and_load",
    "jit_registry",
    "clear_cache",
    "get_native_runtime",
]

KERNEL_SOURCES = ("paged_attention", "paged_attention_gather", "sampling",
                  "mla_attention", "grouped_gemm", "flash_attention", "norm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# a caller's variant: the generated header arrives by -include
USER_VARIANT_FLAGS = ["-DFI_USER_VARIANT"]
_LOCK_STALE_SECONDS = 600

# a kernel name, or (kernel name, generated variant header)
Target = Union[str, Tuple[str, Path]]

_loaded: Dict[str, ctypes.CDLL] = {}


class _Registry:
    """What this process built and loaded, by library name."""

    def __init__(self):
        self.stats: Dict[str, dict] = {}

    def record(self, name: str, lib: Path, built: bool, seconds: float,
               kind: str):
        self.stats[name] = {
            "kind": kind,  # "nvcc" or "host"
            "lib": str(lib),
            "compiled_this_process": built,
            "build_seconds": round(seconds, 3),
        }

    def get_stats(self) -> Dict[str, dict]:
        return dict(self.stats)


jit_registry = _Registry()


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


# ------------------------------------------------------------ CUDA kernels

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _split(target: Target) -> Tuple[str, Optional[Path]]:
    if isinstance(target, str):
        return target, None
    name, header = target
    return name, Path(header)


def _label(target: Target) -> str:
    """The registry's name of a target: ``name``, or ``name:<header stem>``."""
    name, header = _split(target)
    return name if header is None else f"{name}:{header.stem}"


def _flags(header: Optional[Path]) -> List[str]:
    return NVCC_FLAGS + (USER_VARIANT_FLAGS if header is not None else [])


def _lib_path(target: Target) -> Path:
    name, header = _split(target)
    h = hashlib.sha256(" ".join(_flags(header)).encode())
    src = CSRC_DIR / f"{name}.cu"
    included = re.findall(r'^#include "(\w+\.cu)"', src.read_text(),
                          re.MULTILINE)
    srcs = ([src] + [CSRC_DIR / f for f in included]
            + sorted(CSRC_DIR.glob("*.cuh")))
    for p in srcs + ([header] if header is not None else []):
        h.update(p.read_bytes())
    stem = name if header is None else f"{name}-user"
    return CACHE_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_log(target: Target) -> str:
    """The compiler's output (ptxas register and shared-memory report) from
    the build of ``target``, or '' if it was built by another process."""
    log = _lib_path(target).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(targets: Iterable[Target] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every target that is not built yet, one nvcc process per
    library, all started together. Returns seconds spent per built target
    (by ``_label``)."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    pending = [t for t in targets if not _lib_path(t).exists()]
    procs = {}
    t0 = time.time()
    waiting: List[Target] = []
    for target in pending:
        name, header = _split(target)
        lib = _lib_path(target)
        lock = lib.with_suffix(".lock")
        if not _take_lock(lock):
            waiting.append(target)
            continue
        extra = [] if header is None else ["-include", str(header)]
        cmd = [_nvcc(), *_flags(header), *extra, "-I", str(CSRC_DIR),
               str(CSRC_DIR / f"{name}.cu"), "-o", str(lib) + ".tmp"]
        procs[_label(target)] = (target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lock)
    seconds: Dict[str, float] = {}
    errors = []
    for label, (target, proc, lock) in procs.items():
        try:
            out, _ = proc.communicate()
            lib = _lib_path(target)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {label}:\n{out}")
                continue
            lib.with_suffix(".log").write_text(out)
            os.replace(str(lib) + ".tmp", lib)
            seconds[label] = time.time() - t0
            jit_registry.record(label, lib, True, seconds[label], "nvcc")
        finally:
            lock.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    for target in waiting:  # another process holds the lock: wait for its .so
        lib = _lib_path(target)
        lock = lib.with_suffix(".lock")
        while not lib.exists():
            if not lock.exists():  # that build failed or was abandoned
                seconds.update(build_all([target]))
                break
            time.sleep(0.2)
    return seconds


def load(name: str, header: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (with a caller variant's
    ``header``, its own build), built first if needed; a library loaded
    before comes from memory, with no build and no file read."""
    target: Target = name if header is None else (name, Path(header))
    label = _label(target)
    lib = _loaded.get(label)
    if lib is None:
        built = build_all([target])
        path = _lib_path(target)
        lib = ctypes.CDLL(str(path))
        _loaded[label] = lib
        if label not in built:
            jit_registry.record(label, path, False, 0.0, "nvcc")
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ------------------------------------------------------------ host runtime

@dataclasses.dataclass(frozen=True)
class JitSpec:
    """A host build unit: name, C++ sources (relative to ``csrc/host``, or
    absolute) and extra flags (``flashinfer_tpu/jit/core.py:42``)."""

    name: str
    sources: Sequence[str]
    flags: Sequence[str] = ()

    def source_paths(self) -> List[Path]:
        return [Path(s) if os.path.isabs(s) else HOST_CSRC_DIR / s
                for s in self.sources]

    def content_hash(self) -> str:
        h = hashlib.sha256(" ".join(list(self.flags) + cxxflags()).encode())
        # every header of csrc/host: the sources include fi_native.h (struct
        # layouts and the ABI constant), and a stale library with another
        # struct layout would corrupt memory through ctypes without a word
        for p in self.source_paths() + sorted(HOST_CSRC_DIR.glob("*.h")):
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    @property
    def lib_path(self) -> Path:
        return NATIVE_BUILD_DIR / f"{self.name}-{self.content_hash()}.so"


def _locked_build(spec: JitSpec, lib: Path) -> None:
    lock = lib.with_suffix(".lock")
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    while not _take_lock(lock):  # another process builds: wait for its .so
        if lib.exists():
            return
        time.sleep(0.1)
    try:
        if lib.exists():
            return
        cmd = ([cxx()] + cxxflags() + list(spec.flags)
               + ["-I", str(HOST_CSRC_DIR)]
               + [str(p) for p in spec.source_paths()]
               + ["-o", str(lib) + ".tmp"])
        logger.info("building host module %s: %s", spec.name, " ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"host build of {spec.name} failed:\n{res.stderr}")
        os.replace(str(lib) + ".tmp", lib)
    finally:
        lock.unlink(missing_ok=True)


def build_and_load(spec: JitSpec) -> ctypes.CDLL:
    """Compile ``spec`` if it is not cached, then load it with ctypes (its
    own handle: ``RTLD_LOCAL``, so a library of the same C symbols loaded
    by another package stays apart)."""
    lib = spec.lib_path
    t0 = time.time()
    built = not lib.exists()
    if built:
        _locked_build(spec, lib)
    jit_registry.record(spec.name, lib, built, time.time() - t0, "host")
    return ctypes.CDLL(str(lib))


def clear_cache() -> int:
    """Remove every cached build (libraries, logs, locks); returns the
    number of files removed. Libraries already loaded stay loaded."""
    n = 0
    if CACHE_DIR.exists():
        for p in CACHE_DIR.iterdir():
            if p.is_file():
                p.unlink()
                n += 1
    return n


_NATIVE_RUNTIME_SPEC = JitSpec(name="fi_native",
                               sources=("planner.cc", "page_pool.cc"))
_ABI_VERSION = 4

_runtime: Optional[ctypes.CDLL] = None
_runtime_failed: Optional[str] = None


def get_native_runtime() -> Optional[ctypes.CDLL]:
    """The host runtime (planner and page pool), or None where it cannot be
    built here (no C++ compiler): the NumPy planner and the Python pool
    take over, as in the JAX package. A library of another ABI raises."""
    global _runtime, _runtime_failed
    if _runtime is not None:
        return _runtime
    if _runtime_failed is not None:
        return None
    try:
        lib = build_and_load(_NATIVE_RUNTIME_SPEC)
    except (OSError, RuntimeError) as e:  # no compiler, or it failed
        _runtime_failed = str(e)
        logger.warning("native runtime unavailable (%s); using the NumPy "
                       "planner and the Python page pool", e)
        return None
    lib.fi_native_abi_version.restype = ctypes.c_int64
    got = lib.fi_native_abi_version()
    if got != _ABI_VERSION:
        raise RuntimeError(f"native ABI {got} != expected {_ABI_VERSION}")
    _runtime = lib
    return lib
