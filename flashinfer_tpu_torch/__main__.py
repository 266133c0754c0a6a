"""``python -m flashinfer_tpu_torch``: the port's command line.

Counterpart of ``flashinfer_tpu/__main__.py``, with its subcommands:

  show-config   version, torch and CUDA versions, the card (name and power
                limit as nvidia-smi reports them), the planner, the native
                runtime, the cache and the FLASHINFER_TPU_* environment
  cache-status  the cached builds (nvcc libraries, the host runtime)
  cache-clear   delete them
  list-ops      the public API's names
  aot           build everything and run the default universe once
                (``aot.warmup``)
  tune          time the autotuner's tactics (the paged and MLA prefill
                tiles) on the card over a grid of serving shapes and persist
                the winners
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys


def _card() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"available": False}
    info = {"available": True, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        info["nvidia_smi"] = out.stdout.strip().splitlines()
    return info


def _cmd_show_config(_args) -> int:
    import torch

    import flashinfer_tpu_torch
    from flashinfer_tpu_torch.jit import CACHE_DIR, jit_registry
    from flashinfer_tpu_torch.jit.env import planner_backend
    from flashinfer_tpu_torch.scheduler.native import native_plan_available

    info = {
        "flashinfer_tpu_torch_version": flashinfer_tpu_torch.__version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": _card(),
        "cache_dir": str(CACHE_DIR),
        "planner_backend": planner_backend(),
        "native_runtime_available": native_plan_available(),
        "native_modules": jit_registry.get_stats(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("FLASHINFER_TPU_", "CUDA_"))},
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_cache_status(_args) -> int:
    from flashinfer_tpu_torch.jit import CACHE_DIR

    entries = []
    if CACHE_DIR.exists():
        entries = [{"file": p.name, "bytes": p.stat().st_size}
                   for p in sorted(CACHE_DIR.glob("*.so"))]
    print(json.dumps({"dir": str(CACHE_DIR), "entries": entries}, indent=2))
    return 0


def _cmd_cache_clear(_args) -> int:
    from flashinfer_tpu_torch.jit import clear_cache

    print(f"removed {clear_cache()} cached build files")
    return 0


def _cmd_list_ops(_args) -> int:
    import flashinfer_tpu_torch

    for name in sorted(flashinfer_tpu_torch.__all__):
        print(name)
    return 0


def _cmd_aot(args) -> int:
    from flashinfer_tpu_torch.aot import warmup

    n = warmup(configs=args.config or None, verbose=True,
               device=args.device)
    print(f"warmed {n} configs")
    return 0


def _cmd_tune(args) -> int:
    """Time the prefill tile tactics of the paged and MLA wrappers over a
    few serving shapes and persist the winners."""
    import numpy as np
    import torch

    from flashinfer_tpu_torch.autotuner import AutoTuner, autotune, \
        get_config_path
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchPrefillWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    prefill = [(8, 1024, 32, 8), (4, 2048, 16, 16)]
    mla = [(8, 512, 16)]
    if args.quick:
        prefill, mla = prefill[:1], mla[:1]
    ps, d = 16, 128
    with autotune():
        if args.only in (None, "prefill"):
            for b, sq, hq, hkv in prefill:
                pages = sq // ps
                indptr = np.arange(b + 1) * pages
                indices = rng.permutation(b * pages).astype(np.int32)
                kc, vc = (randn(b * pages, hkv, ps, d) for _ in range(2))
                w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="HND",
                                                        device=dev)
                w.plan(np.arange(b + 1) * sq, indptr, indices,
                       np.full(b, ps, np.int32), hq, hkv, d, ps, causal=True)
                w.run(randn(b * sq, hq, d), (kc, vc))
                print(f"tuned paged prefill b{b} s{sq} h{hq}/{hkv}",
                      flush=True)
        if args.only in (None, "mla"):
            for b, sq, h in mla:
                pages = sq // ps
                w = BatchMLAPagedAttentionWrapper(device=dev)
                w.plan(np.arange(b + 1) * sq, np.arange(b + 1) * pages,
                       np.arange(b * pages, dtype=np.int32), np.full(b, sq),
                       h, 512, 64, ps, causal=True)
                w.run(randn(b * sq, h, 512), randn(b * sq, h, 64),
                      randn(b * pages, ps, 512), randn(b * pages, ps, 64))
                print(f"tuned mla prefill b{b} s{sq} h{h}", flush=True)
    t = AutoTuner.get()
    print(f"profiled {t.stats.profiled_tactics} tactics across "
          f"{t.stats.tuned_ops} ops -> {get_config_path()}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flashinfer_tpu_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("show-config", help="version, card, planner, cache, env")
    sub.add_parser("cache-status", help="list the cached builds")
    sub.add_parser("cache-clear", help="delete the cached builds")
    sub.add_parser("list-ops", help="list the public API's names")
    p_aot = sub.add_parser("aot", help="build everything and run the "
                           "default kernel universe once")
    p_aot.add_argument("--config", action="append", help="config name(s)")
    p_aot.add_argument("--device", default="cuda")
    p_tune = sub.add_parser("tune", help="time the prefill tile tactics on "
                            "the card and persist the winners")
    p_tune.add_argument("--quick", action="store_true",
                        help="one shape a section")
    p_tune.add_argument("--only", choices=("prefill", "mla"),
                        help="tune one section")
    p_tune.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return {
        "show-config": _cmd_show_config,
        "cache-status": _cmd_cache_status,
        "cache-clear": _cmd_cache_clear,
        "list-ops": _cmd_list_ops,
        "aot": _cmd_aot,
        "tune": _cmd_tune,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
