#!/usr/bin/env python3
"""Time the sampler kernel of several checkouts in turns on one card.

    python3 tools/sampler_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``flashinfer_tpu_torch`` and runs its ``family_call`` on the
cases of this checkout's ``chip_smoke.check_sampler``: the seq filter's
draw (top-k 40, top-p 0.9) at [8, 128256] (Llama-3-8B), [8, 102400] and
[1, 102400] (DeepSeek-V2-Lite), and renorm and mask_logits at [8, 128256],
each held to that checkout's plain version (tokens and masks exact,
renorm to ``chip_smoke.SAMPLER_RENORM_TOL``) and timed over 20 calls in one
CUDA graph. Prints the card and a line per case with each run's ms (and, in
brackets, how many of its clusters the card runs at once, where the
checkout's ``sampler_route`` reports it) and the bound (``tools/ab.py``).
Exits 1 if a run fails or disagrees with the plain version.
"""

from __future__ import annotations

import json
import os
import sys

import ab


def child() -> None:
    """One run, from the root of the checkout under test."""
    import torch

    cs = ab.chip_smoke()
    from flashinfer_tpu_torch.ops import sampling as mod

    route = getattr(mod, "sampler_route", None)
    rows = []
    for case in cs.sampler_cases(torch):
        x, k, p, mode, filt = (case[n] for n in ("x", "k", "p", "mode",
                                                 "filt"))

        def call(fn, seed=12345):
            return fn(x, seed, k, p, filt=filt, out_mode=mode)

        got, want = call(mod.family_call), call(mod.family_plain)
        if mode == "renorm":
            ok = float((got - want).abs().max()) <= cs.SAMPLER_RENORM_TOL
        else:
            ok = bool(torch.equal(got, want))
        ms = cs.cuda_ms(torch, lambda: call(mod.family_call), 20, graph=True)
        # clusters the card runs at once (None: a version that does not
        # report it)
        clusters = (route(x.shape[1]).get("max_active_clusters")
                    if route is not None else None)
        rows.append(dict(case=case["name"], ms=ms, ok=ok,
                         bound_ms=case["bound_ms"],
                         bound_by=case["bound_by"], clusters=clusters))
    print("ROWS " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        args = ab.parse_args(__doc__)
        sys.exit(ab.run(args.dirs, [os.path.abspath(__file__), "--child"],
                        args.out, cell=lambda r: f"{r['ms']:.4f} "
                        f"[{r['clusters']}]"))
