#!/usr/bin/env python3
"""Time the flash-attention kernel of several checkouts in turns on one card.

    python3 tools/flash_ab.py DIR [DIR ...] [--cases a,b] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``flashinfer_tpu_torch`` and times ``flash_attention_dense``
on the cases of this checkout's ``chip_smoke.FLASH_CASES`` named by
``--cases`` (default: the Llama-3-8B prefill, chunked prefill and 32K
decode, the packed random-bit custom mask and the small f32 case), each
built by ``chip_smoke._flash_case`` from one seeded generator and timed as
``chip_smoke.check_flash_attention`` times it (a CUDA graph of 5 or 20
calls). Prints the card, then a line per case with each run's ms and the
first run's bound (``tools/ab.py``); exits 1 if a run fails.
"""

from __future__ import annotations

import json
import os
import sys

import ab

DEFAULT = "llama_prefill,chunked_prefill,decode,custom_mask,small_f32"


def child(names) -> None:
    """One run, from the root of the checkout under test."""
    import numpy as np
    import torch

    cs = ab.chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for name, qo, kv, hq, hkv, d, dv, dtype, causal, variant in \
            cs.FLASH_CASES:
        if name not in names:
            continue
        kernel, _, _, extra, pairs, inputs = cs._flash_case(
            torch, np, qo, kv, hq, hkv, d, dv, dtype, causal, variant, gen)
        big = qo * kv >= 2 ** 24
        ms = cs.cuda_ms(torch, kernel, 5 if big else 20,
                        warmup=1 if big else 2, graph=True)
        isz = 2 if dtype == "bf16" else 4
        nbytes = ((qo * hq * (d + dv) + kv * hkv * (d + dv)) * isz
                  + qo * hq * 4 + extra)
        b_ms, b_by = cs.bound_ms(nbytes, 2 * (d + dv) * pairs * hq, dtype)
        rows.append(dict(case=name, ms=ms, bound_ms=b_ms, bound_by=b_by))
        del kernel, inputs
        torch.cuda.empty_cache()
    print("ROWS " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2].split(","))
    else:
        args = ab.parse_args(__doc__, (("--cases",), dict(default=DEFAULT)))
        sys.exit(ab.run(args.dirs, [os.path.abspath(__file__), "--child",
                                    args.cases], args.out))
