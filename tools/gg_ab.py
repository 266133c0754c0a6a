#!/usr/bin/env python3
"""Time the grouped-GEMM kernel of several checkouts in turns on one card.

    python3 tools/gg_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``chip_smoke`` and runs its ``check_grouped_gemm``: the
kernel built from that checkout's sources, held against its plain version,
timed in a CUDA graph beside ``torch._grouped_mm``. Prints the card, then a
line per (case, GEMM, weight type) with each run's ms (its m-tile in
brackets), the library's ms (first run) and the bound (``tools/ab.py``);
exits 1 if a run fails or disagrees. ``--max-tm`` caps the m-tile that
``select_moe_tm`` picks, in every run.
"""

from __future__ import annotations

import sys

import ab

CHILD = ("import importlib, json, sys, numpy as np, torch, chip_smoke; "
         "fm = importlib.import_module('flashinfer_tpu_torch.ops.fused_moe'); "
         "pick = fm.select_moe_tm; "
         "fm.select_moe_tm = lambda r, e: min(pick(r, e), int(sys.argv[1])); "
         "rows = chip_smoke.check_grouped_gemm(torch, np); "
         "print('ROWS ' + json.dumps(rows))")


if __name__ == "__main__":
    args = ab.parse_args(__doc__, (("--max-tm",), dict(type=int, default=128)))
    sys.exit(ab.run(
        args.dirs, ["-c", CHILD, str(args.max_tm)], args.out,
        label=lambda r: f"{r['case']} {r['gemm']} {r['w']}",
        cell=lambda r: f"{r['ms']:.4f} [{r['tm']}]",
        columns=[("library", lambda r: "-" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f}")]))
