"""Ahead-of-time warm-up: build the native code, then run the default
kernel universe once.

Counterpart of ``flashinfer_tpu/aot.py``. JAX fills XLA's persistent
compilation cache with (op, shape bucket) executables; the port's compiled
artefacts are its nvcc libraries and its host runtime, which ``warmup``
builds (``jit.build_all`` and ``jit.get_native_runtime``, into the cache
directory), before it runs each ``AotConfig`` of the universe once on the
device, so a later process finds everything built and every launch path
exercised. On ``device="cpu"`` nothing is built with nvcc and each config
runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

__all__ = ["AotConfig", "default_universe", "warmup"]


@dataclasses.dataclass(frozen=True)
class AotConfig:
    """One warm-up target: a named (op, shape, dtype) combination."""

    name: str
    op: str  # "decode" | "prefill" | "ragged" | "sampling" | "norm_rope_act"
    batch: int = 8
    seq: int = 128
    kv_len: int = 512
    num_qo_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    page_size: int = 16
    dtype: str = "bfloat16"
    causal: bool = True


def default_universe() -> list[AotConfig]:
    """decode / prefill / ragged x head dims {64, 128, 256} x heads {8/8,
    8/2}, the sampler and norm + activation (JAX's names)."""
    configs = [
        AotConfig(name=f"{op}_h{hq}x{hkv}_d{hd}", op=op, num_qo_heads=hq,
                  num_kv_heads=hkv, head_dim=hd)
        for op, hd, (hq, hkv) in itertools.product(
            ("decode", "prefill", "ragged"), (64, 128, 256),
            ((8, 8), (8, 2)))]
    configs.append(AotConfig(name="sampling", op="sampling"))
    configs.append(AotConfig(name="norm_rope_act", op="norm_rope_act"))
    return configs


def _run_attention(cfg: AotConfig, dev: torch.device) -> torch.Tensor:
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
        BatchPrefillWithPagedKVCacheWrapper,
        BatchPrefillWithRaggedKVCacheWrapper,
    )

    dtype = getattr(torch, cfg.dtype)
    b, d, ps = cfg.batch, cfg.head_dim, cfg.page_size
    hq, hkv = cfg.num_qo_heads, cfg.num_kv_heads
    if cfg.op == "ragged":
        w = BatchPrefillWithRaggedKVCacheWrapper(kv_layout="NHD", device=dev)
        w.plan(np.arange(b + 1) * cfg.seq, np.arange(b + 1) * cfg.kv_len, hq,
               hkv, d, causal=cfg.causal)
        q = torch.zeros(b * cfg.seq, hq, d, dtype=dtype, device=dev)
        k = torch.zeros(b * cfg.kv_len, hkv, d, dtype=dtype, device=dev)
        return w.run(q, (k, k))
    pages = -(-cfg.kv_len // ps)
    indptr = np.arange(b + 1) * pages
    indices = np.arange(b * pages, dtype=np.int32)
    last = np.full(b, ((cfg.kv_len - 1) % ps) + 1, np.int32)
    kc = torch.zeros(b * pages + 1, hkv, ps, d, dtype=dtype, device=dev)
    if cfg.op == "decode":
        w = BatchDecodeWithPagedKVCacheWrapper(kv_layout="HND", device=dev)
        w.plan(indptr, indices, last, hq, hkv, d, ps)
        q = torch.zeros(b, hq, d, dtype=dtype, device=dev)
    else:
        w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="HND", device=dev)
        w.plan(np.arange(b + 1) * cfg.seq, indptr, indices, last, hq, hkv, d,
               ps, causal=cfg.causal)
        q = torch.zeros(b * cfg.seq, hq, d, dtype=dtype, device=dev)
    return w.run(q, (kc, kc))


def _run_misc(cfg: AotConfig, dev: torch.device) -> None:
    from flashinfer_tpu_torch.ops import sampling as S
    from flashinfer_tpu_torch.ops.activation import silu_and_mul
    from flashinfer_tpu_torch.ops.norm import rmsnorm

    if cfg.op == "sampling":
        probs = torch.full((cfg.batch, 1024), 1 / 1024, device=dev)
        S.top_p_sampling_from_probs(probs, 0.9, seed=0)
        S.top_k_sampling_from_probs(probs, 40, seed=0)
        S.min_p_sampling_from_probs(probs, 0.05, seed=0)
        S.sampling_from_probs(probs, seed=0)
    else:
        rows = cfg.batch * cfg.seq
        x = torch.zeros(rows, 4 * cfg.head_dim, dtype=torch.bfloat16,
                        device=dev)
        rmsnorm(x, torch.ones(4 * cfg.head_dim, dtype=torch.bfloat16,
                              device=dev))
        silu_and_mul(torch.zeros(rows, 8 * cfg.head_dim, dtype=torch.bfloat16,
                                 device=dev))


def warmup(
    configs: Optional[Iterable[str]] = None,
    universe: Optional[Sequence[AotConfig]] = None,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> int:
    """Build the native code, then run each config once (``configs``
    filters the universe by name substring). Returns the number run."""
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        secs = jit.build_all()
        if verbose:
            print(f"[aot] nvcc built {sorted(secs)} "
                  f"({len(jit.KERNEL_SOURCES) - len(secs)} cached)",
                  flush=True)
    if jit.get_native_runtime() is None and verbose:
        print("[aot] the host runtime did not build", flush=True)
    universe = list(universe or default_universe())
    if configs:
        pats = list(configs)
        universe = [c for c in universe if any(p in c.name for p in pats)]
    for cfg in universe:
        if verbose:
            print(f"[aot] running {cfg.name}", flush=True)
        if cfg.op in ("decode", "prefill", "ragged"):
            _run_attention(cfg, dev)
        else:
            _run_misc(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return len(universe)
