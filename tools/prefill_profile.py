"""Where the Llama engine's prefill step spends its device time, on one
CUDA card; prints the card's name and power limit, the step's plan, its
device ms and its kernels by device time (torch.profiler).

  python3 tools/prefill_profile.py [--min-splits 1,4]

Llama-3-8B at full width (random bf16 weights from a seed), 8 slots, the
engine phase's first admission of ``chip_smoke.py`` (8 prompts of 64-512
tokens, 1724 rows in the 2048-row bucket), the step run eagerly on its
input buffer. Each value of ``--min-splits`` plans the admission again
with the merge's split count floored there (the engine's own plan leaves
it to the batch: 1 here, no prompt crossing the 512-key chunk): 4, the
most a 2048-row bucket can need, runs the split merge in every layer.
"""

import argparse
import os
import subprocess
import sys


def profile(torch, body, runs=3, top=20):
    """(device ms a run, [(ms a run, launches a run, kernel)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    body()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            body()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total / 1e3 / runs, ev.count // runs,
             ev.key[:100]) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    return sum(r[0] for r in rows), sorted(rows, reverse=True)[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--min-splits", default="1,4",
                    help="comma-separated floors of the merge's splits")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flashinfer_tpu_torch import (
        EngineConfig,
        LlamaConfig,
        LlamaServingEngine,
    )
    from flashinfer_tpu_torch.models.llama import llama_init_weights

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    mc = LlamaConfig.llama3_8b()
    params = llama_init_weights(
        torch.Generator(device="cuda").manual_seed(0), mc, "cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 12)
    prompts = [rng.integers(0, mc.vocab_size, int(n)).tolist()
               for n in lens[:8]]
    for floor in (int(x) for x in args.min_splits.split(",")):
        eng = LlamaServingEngine(EngineConfig(
            model=mc, max_batch=8, greedy=True, cuda_graphs=False,
            device="cuda"), params=params)
        pins = eng._prefill_pins
        eng._prefill_pins = lambda b, r: dict(pins(b, r),
                                              min_max_splits=floor)
        for p in prompts:
            eng.add_request(p, 1)
        eng.step()  # the admission: plans and fills the step's buffer
        key = next(k for k in eng.graphs._bufs if k[0] == "prefill")
        meta = key[1]
        ms, rows = profile(torch, lambda: eng.graphs.run(
            key, eng._prefill_body))
        print(f"min splits {floor}: {meta.nnz} rows, bucket_rows "
              f"{meta.bucket_rows}, {meta.num_work_items} work items, "
              f"max_splits {meta.max_splits}: device {ms:.3f} ms a step")
        for k_ms, n, name in rows:
            print(f"  {k_ms:8.3f} ms  x{n:<4d} {name}")
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
