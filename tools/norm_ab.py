#!/usr/bin/env python3
"""Time the RMSNorm kernel of several checkouts in turns on one card.

    python3 tools/norm_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``flashinfer_tpu_torch`` and times, at Llama-3-8B decode
[8, 4096], DeepSeek-V2-Lite decode [8, 2048] and Llama-3-8B prefill
[4096, 4096] bf16, 100 calls in one CUDA graph each:

* ``norm``: ``rmsnorm``; ``add+norm``: ``x + r`` then ``rmsnorm`` (the pair
  the serving steps ran before the fused form); ``fused``:
  ``fused_add_rmsnorm``; ``empty``: the empty kernel of the norm's layout
  (``rmsnorm_empty``); the last two where the checkout has them;
* at decode rows, as the served step orders them, each behind the matmul
  that writes its x (``x @ W``, W [hidden, hidden]: the o-projection's
  shape): ``mm`` alone, and each of ``mm+norm``, ``mm+add+norm``,
  ``mm+fused`` and ``mm+empty`` as its time beyond ``mm`` (the graph of
  both, less the matmul's graph);
* ``F.rms_norm`` and ``x + r`` then ``F.rms_norm``, the library's calls.

Each checkout's norm (and fused norm) is held to its plain version first
(``chip_smoke.NORM_TOL``; the fused residual bit for bit). ``--cases RE``
times only the cases whose label ("llama mm+fused", say) matches RE.
Prints the card and a line per case with each run's ms ("-": not timed)
and the first run's bound (``tools/ab.py``); exits 1 if a run fails or
disagrees.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys

import ab

SHAPES = (("llama", 8, 4096, 1e-5), ("deepseek", 8, 2048, 1e-6),
          ("llama_prefill", 4096, 4096, 1e-5))


def child(pattern: str) -> None:
    """One run, from the root of the checkout under test, of the cases
    whose label matches ``pattern``."""
    import torch
    import torch.nn.functional as F

    cs = ab.chip_smoke()
    from flashinfer_tpu_torch.ops import norm as mod

    fused = getattr(mod, "fused_add_rmsnorm", None)
    empty = getattr(mod, "rmsnorm_empty", None)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for name, n, hidden, eps in SHAPES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen,
                               dtype=torch.bfloat16)

        x, r, a = randn(n, hidden), randn(n, hidden), randn(n, hidden)
        w = (1 + 0.1 * randn(hidden).float()).to(torch.bfloat16)
        wmat = randn(hidden, hidden) / math.sqrt(hidden)
        want = mod.rmsnorm_plain(x, w, eps)
        ok = bool(((mod.rmsnorm(x, w, eps).float() - want.float()).abs()
                   <= cs.NORM_TOL * want.float().abs() + 1e-6).all())
        if fused is not None:
            got, got_r = fused(x, r, w, eps)
            want_r = (x.float() + r.float()).to(x.dtype)
            want = mod.rmsnorm_plain(want_r, w, eps)
            ok = ok and torch.equal(got_r, want_r) and bool(
                ((got.float() - want.float()).abs()
                 <= cs.NORM_TOL * want.float().abs() + 1e-6).all())

        def ms(fn):
            return cs.cuda_ms(torch, fn, 100, graph=True)

        b = cs.bound_ms(2 * x.numel() * 2 + hidden * 2, 4 * x.numel())
        fb = cs.bound_ms(4 * x.numel() * 2 + hidden * 2, 5 * x.numel())
        none = (0.0, "none")
        cases = [
            ("norm", lambda: mod.rmsnorm(x, w, eps), b),
            ("add+norm", lambda: mod.rmsnorm(r + x, w, eps), fb),
            ("fused", fused and (lambda: fused(x, r, w, eps)), fb),
            ("empty", empty and (lambda: empty(x, w)), none)]
        if n <= 8:
            cases += [
                ("mm", lambda: a @ wmat, cs.bound_ms(
                    hidden * hidden * 2 + 2 * x.numel() * 2,
                    2 * n * hidden * hidden)),
                ("mm+norm", lambda: mod.rmsnorm(a @ wmat, w, eps), b),
                ("mm+add+norm", lambda: mod.rmsnorm(r + a @ wmat, w, eps),
                 fb),
                ("mm+fused", fused and (lambda: fused(a @ wmat, r, w, eps)),
                 fb),
                ("mm+empty", empty and (lambda: empty(a @ wmat, w)), none)]
        cases += [
            ("F.rms_norm", lambda: F.rms_norm(x, (hidden,), w, eps), b),
            ("x+r, F.rms_norm",
             lambda: F.rms_norm(r + x, (hidden,), w, eps), fb)]
        wanted = {c for c, fn, _ in cases
                  if fn is not None and re.search(pattern, f"{name} {c}")}
        fns = dict((c, fn) for c, fn, _ in cases)
        t = {c: ms(fns[c]) for c in wanted}
        # an mm+ case is its time beyond the matmul's
        if any(c.startswith("mm+") for c in t):
            mm = t.get("mm") or ms(fns["mm"])
            t.update({c: v - mm for c, v in t.items() if c.startswith("mm+")})
        rows += [dict(case=f"{name} {c}", ms=t.get(c), ok=ok, bound_ms=bd[0],
                      bound_by=bd[1]) for c, _, bd in cases]
    print("ROWS " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        args = ab.parse_args(__doc__, (("--cases",), dict(
            default="", help="time only the cases whose label matches "
            "this regular expression")))
        sys.exit(ab.run(args.dirs, [os.path.abspath(__file__), "--child",
                                    args.cases], args.out,
                        cell=lambda r: "-" if r["ms"] is None
                        else f"{r['ms']:.5f}"))
