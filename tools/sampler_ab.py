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
CUDA graph. Prints the card, a line per case with each run's ms and the
bound, then how many of each run's clusters the card runs at once at the
first case's vocabulary (where the checkout's ``sampler_route`` reports
it). Exits 1 if a run fails or disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child() -> None:
    """One run, from the root of the checkout under test."""
    import torch

    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs, bad = [], []
    for d in args.dirs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child"], cwd=d,
                              capture_output=True, text=True, timeout=900)
        rows = next((json.loads(ln[5:]) for ln in proc.stdout.splitlines()
                     if ln.startswith("ROWS ")), None)
        if rows is None:
            print(f"run in {d} failed (exit {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            return 1
        name = os.path.basename(os.path.normpath(os.path.abspath(d)))
        bad += [f"{name} {r['case']}" for r in rows if not r["ok"]]
        runs.append((name, rows))
    print(card)
    print("case | " + " | ".join(name for name, _ in runs) + " | bound")
    for i, r in enumerate(runs[0][1]):
        ms = " | ".join(f"{rows[i]['ms']:.4f}" for _, rows in runs)
        print(f"{r['case']} | {ms} | {r['bound_ms']:.5f} ({r['bound_by']})")
    print("clusters at once | " + " | ".join(
        str(rows[0]["clusters"]) for _, rows in runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f, indent=1)
    if bad:
        print(f"disagree with the plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child()
    else:
        sys.exit(main())
