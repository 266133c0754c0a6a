#!/usr/bin/env python3
"""Time the MLA attention kernel of several checkouts in turns on one card.

    python3 tools/mla_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``flashinfer_tpu_torch`` and runs its ``mla_paged_run`` on
the cases of this checkout's ``chip_smoke.mla_cases`` (DeepSeek-V2-Lite
widths: the check's decode and causal prefill at tile_q 128 and 64 on
bf16, e4m3 and int8 caches, and the decode the DeepSeek path serves), each
held to that checkout's ``mla_paged_plain`` and timed as ``check_mla``
times it (one CUDA graph). Prints the card, then a line per case with each
run's ms and the bound (``tools/ab.py``); exits 1 if a run fails or
disagrees with the plain version.
"""

from __future__ import annotations

import json
import os
import sys

import ab


def child() -> None:
    """One run, from the root of the checkout under test."""
    import numpy as np
    import torch

    cs = ab.chip_smoke()
    from flashinfer_tpu_torch.ops.attention.mla import (
        mla_paged_plain,
        mla_paged_run,
    )

    rows = []
    for case in cs.mla_cases(torch, np):
        call = case["call"]
        chk = cs._attn_check(torch, call(mla_paged_run, rotate=False),
                             call(mla_paged_plain, rotate=False))
        ms = cs.cuda_ms(torch, lambda: call(mla_paged_run), case["iters"],
                        graph=True)
        rows.append(dict(
            case=f"{case['mode']} {case['kv']} tile_q {case['meta'].tile_q}",
            ms=ms, ok=chk["ok"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"]))
        del case, call
        torch.cuda.empty_cache()
    print("ROWS " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        args = ab.parse_args(__doc__)
        sys.exit(ab.run(args.dirs, [os.path.abspath(__file__), "--child"],
                        args.out))
