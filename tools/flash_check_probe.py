"""Probes of the flash kernel's check on one CUDA card; prints one line per
result and the card's name and power limit.

  python3 tools/flash_check_probe.py --seeds 6
      For the variant check inputs that round P far from or near a
      unit-size P.V sum (sigmoid scale 0.5 / bias -2 and scale 1 / bias
      -log(n); soft cap 50 with q scaled by 1, 2, 4, 8 or with a large
      component shared by every key), at Llama-3-8B widths on 2048 causal
      tokens: the largest kernel-vs-plain error over the ATTN limit on each
      seed, for the soft cap also how far the cap moves o over that limit,
      and for the sigmoid ``chip_smoke._sigmoid_witness`` (the kernel's and
      the plain version's errors against float64, and the bf16 weight
      flips behind them).

  python3 tools/flash_check_probe.py --sink-decode [--tree DIR]
      CUDA-graph and eager times of a 32K-key decode with per-head sinks
      (split KV), through the ``flashinfer_tpu_torch`` of DIR (default:
      this checkout); run it on two trees in turns to compare them.
"""

import argparse
import math
import os
import subprocess
import sys

N, HQ, HKV, D = 2048, 32, 8, 128


def probe_variants(torch, np, cs, seeds):
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )
    from flashinfer_tpu_torch.ops.attention.variants import (
        FlashSigmoid,
        make_default_variant,
    )

    cap = make_default_variant(logits_soft_cap=50.0)
    designs = [("sigmoid 0.5, -2", FlashSigmoid(0.5, -2.0), 1.0, 0.0),
               ("sigmoid 1, -log n", FlashSigmoid(1.0, -math.log(N)), 1.0,
                0.0)]
    designs += [(f"soft cap q x {s:g}", cap, s, 0.0) for s in (1, 2, 4, 8)]
    designs += [(f"soft cap k offset {o:g}", cap, 1.0, o) for o in (24, 40)]
    kw = dict(causal=True, sm_scale=D ** -0.5)
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(100 + seed)

        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        q, k, v = (randn(n, h, D).bfloat16()
                   for n, h in ((N, HQ), (N, HKV), (N, HKV)))
        shared = randn(1, HKV, D)
        for name, variant, q_scale, offset in designs:
            qx = q * q_scale
            kx = (k.float() + offset * shared).bfloat16()
            got = flash_attention_dense(qx, kx, v, variant=variant, **kw)
            want = flash_attention_plain(qx, kx, v, variant=variant, **kw)
            chk = cs._attn_check(torch, got, want)
            line = (f"seed {seed} {name:22s} kernel vs plain: limit ratio "
                    f"{chk['o_ratio']:.3f} at |ref| {chk['ref_at_worst']:.4f}")
            if variant is cap:
                nocap = flash_attention_plain(qx, kx, v, **kw)
                moved = cs._attn_check(torch, nocap, want)["o_ratio"]
                line += f"; the cap moves o by {moved:.1f} of the limit"
            print(line, flush=True)
            if variant is not cap:
                cs._sigmoid_witness(torch, np, (qx, kx, v,
                                                dict(variant=variant, **kw)),
                                    got, want)


def probe_sink_decode(torch, cs):
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(1, HQ, D, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(32768, HKV, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    sink = torch.randn(HQ, device="cuda", generator=gen) * 4

    def f():
        return flash_attention_dense(q, k, v, sink=sink)

    chk = cs._attn_check(torch, f(), flash_attention_plain(q, k, v,
                                                           sink=sink))
    graph = [cs.cuda_ms(torch, f, 50, graph=True) for _ in range(3)]
    print(f"decode 32K keys with sinks: graph ms {graph}, eager ms "
          f"{cs.cuda_ms(torch, f, 50):.4f}; limit ratio {chk['o_ratio']:.3f}"
          f" ok {chk['ok']}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--sink-decode", action="store_true")
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("flash_check_probe: no CUDA card", file=sys.stderr)
        return 2
    if args.seeds:
        probe_variants(torch, np, cs, args.seeds)
    if args.sink_decode:
        probe_sink_decode(torch, cs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
