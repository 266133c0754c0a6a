#!/usr/bin/env python3
"""Time the grouped GEMM as ``w8_matmul`` (8-bit weights, one group) of
several checkouts in turns on one card.

    python3 tools/w8_ab.py DIR [DIR ...] [--rows 8,32,4096] [--out FILE]

Each DIR is the root of a checkout (trees as for ``tools/gg_ab.py``). For
each DIR, in the order given, a fresh process runs that checkout's
``chip_smoke.check_w8_matmul`` at the row counts given: Llama-3-8B's five
weight shapes, e4m3 and int8 weights, held against the plain version and
timed in a CUDA graph over copies of the weight that exceed L2. Prints the
card, then a line per (shape, rows, weight type) with each run's ms, the
first run's bf16 ``torch.matmul`` ms and its bound; exits 1 if a run fails
or disagrees.
"""

from __future__ import annotations

import sys

import ab

CHILD = ("import json, sys, numpy as np, torch; "
         "sys.path.insert(0, '.'); import chip_smoke; "
         "chip_smoke.W8_ROWS = tuple(int(r) for r in sys.argv[1].split(',')); "
         "rows = chip_smoke.check_w8_matmul(torch, np); "
         "print('ROWS ' + json.dumps(rows))")


if __name__ == "__main__":
    args = ab.parse_args(__doc__, (("--rows",), dict(default="8,32,4096")))
    sys.exit(ab.run(
        args.dirs, ["-c", CHILD, args.rows], args.out,
        label=lambda r: f"{r['shape']} {r['K']}->{r['N']} x{r['rows']} "
                        f"{r['w']}",
        columns=[("bf16 matmul", lambda r: f"{r['bf16_matmul_ms']:.4f}")]))
