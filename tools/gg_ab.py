#!/usr/bin/env python3
"""Time the grouped-GEMM kernel of several checkouts in turns on one card.

    python3 tools/gg_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``chip_smoke`` and runs its ``check_grouped_gemm``: the
kernel built from that checkout's sources, held against its plain version,
timed in a CUDA graph beside ``torch._grouped_mm``. Prints the card, then a
line per (case, GEMM, weight type) with each run's ms, the library's ms
(first run) and the bound; exits 1 if a run fails or disagrees. ``--max-tm``
caps the m-tile that ``select_moe_tm`` picks, in every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = ("import importlib, json, sys, numpy as np, torch, chip_smoke; "
         "fm = importlib.import_module('flashinfer_tpu_torch.ops.fused_moe'); "
         "pick = fm.select_moe_tm; "
         "fm.select_moe_tm = lambda r, e: min(pick(r, e), int(sys.argv[1])); "
         "rows = chip_smoke.check_grouped_gemm(torch, np); "
         "print('ROWS ' + json.dumps(rows))")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--max-tm", type=int, default=128)
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for d in args.dirs:
        proc = subprocess.run([sys.executable, "-c", CHILD,
                               str(args.max_tm)], cwd=d,
                              capture_output=True, text=True, timeout=900)
        rows = next((json.loads(ln[5:]) for ln in proc.stdout.splitlines()
                     if ln.startswith("ROWS ")), None)
        if rows is None:
            print(f"run in {d} failed (exit {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            return 1
        runs.append((os.path.basename(os.path.normpath(d)), rows))
    print(card)
    print("case gemm w | " + " | ".join(name for name, _ in runs)
          + " | library | bound (ms, tm in brackets)")
    for i, r in enumerate(runs[0][1]):
        ms = " | ".join(f"{rows[i]['ms']:.4f} [{rows[i]['tm']}]"
                        for _, rows in runs)
        lib = r["library_ms"]
        print(f"{r['case']} {r['gemm']} {r['w']} | {ms} | "
              f"{'-' if lib is None else f'{lib:.4f}'} | "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
