#!/usr/bin/env python3
"""Where the int8 / bf16-q cases of the card test
``test_paged_kernel_matches_plain`` fail, and why.

    python3 tools/paged_int8_witness.py [--seeds 60] [--sweeps 20] [--reps 5]
                                        [--out FILE]

Sweeps: ``--sweeps N`` calls the test for each of its 36 cases in pytest's
collection order, N times in this process, sweep i after
``torch.cuda.manual_seed(i)`` (the test draws its caches and q from the
global CUDA generator, which PyTorch seeds anew in every process); prints
each failure with its message and counts the failures of each case.

Witness: for each int8 / bf16-q shape of the test and each seed below
``--seeds``, draws the test's inputs as the test draws them, right after
``torch.cuda.manual_seed(seed)``, and reads them at k_scale 0.7 and
v_scale 1.3 ("unfolded", as the test read them until it folded the int8
cache's dequant scale in) and with 1/20 folded into both ("folded", as it
reads them now). It checks that ``--reps`` launches of the kernel, and of the
plain version, give the same bits, and counts the inputs where the two
disagree beyond the test's tolerance (2e-2). At each such element it
rebuilds the row in float64: S from the exact products, P = 2^(S - ceil
max S), o without rounding P (``o64``). A key is "open" when the float32
error bound of its S (any summation order, the scale's product, exp2's
error) spans a bf16 rounding boundary of its P. Over the choices of P's
bf16 rounding at the open keys (the 10 that move o most), it finds the
choice that reproduces the kernel's row and the one that reproduces the
plain version's, each to within half a bf16 step of o (1.0 in ``fit``).
Needs a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_cuda as tc  # noqa: E402
from flashinfer_tpu_torch.ops.attention.kernels import paged  # noqa: E402
from flashinfer_tpu_torch.utils import TensorLayout  # noqa: E402

SHAPES = [(mode, tile_q, layout) for mode, tile_q in
          (("decode", None), ("prefill", 16), ("prefill", 64))
          for layout in ("NHD", "HND")]
TOL, OPEN_KEYS = 2e-2, 10
PS, HQ, HKV, D = 16, 8, 2, 64


def draw(mode, tile_q, layout, seed):
    """The test's inputs for (int8, bf16 q), drawn as the test draws them."""
    dp, pages, _ = tc._plan(mode, PS, HQ, HKV, D, np.random.default_rng(0),
                            tile_q)
    torch.cuda.manual_seed(seed)
    shape = ((2 * pages, HKV, PS, D) if layout == "HND"
             else (2 * pages, PS, HKV, D))
    kc, vc = (torch.randn(shape, device="cuda") for _ in range(2))
    kc, vc = ((t * 20).round().clamp(-127, 127).to(torch.int8)
              for t in (kc, vc))
    q = torch.randn(HKV, dp.meta.bucket_rows, D,
                    device="cuda").to(torch.bfloat16)
    kw = dict(tile_q=dp.meta.tile_q, group=HQ // HKV, causal=dp.meta.causal,
              sm_scale=D ** -0.5, kv_layout=TensorLayout[layout],
              kv_indices_offset=pages)
    return (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan")), kw


def ratio(o, ref):
    """|o - ref| / (tol + tol |ref|): above 1 fails the test."""
    return (o.float() - ref.float()).abs() / (TOL + TOL * ref.float().abs())


def bf16(x):
    return x.float().to(torch.bfloat16).double()


def half_steps(o, pred):
    """|o - pred| in half bf16 steps of pred (per column)."""
    e = torch.floor(torch.log2(pred.abs().clamp(min=2.0 ** -100)))
    return (o - pred).abs() / torch.exp2(e - 8)


def row_witness(args, kw, k_scale, v_scale, t, h, r, c, o_k, o_p):
    """The float64 row of item t, kv head h, tile row r, and which bf16
    roundings of P reproduce the kernel's and the plain version's rows."""
    q, kc, vc, kv_idx, plan = args
    p = plan.reshape(12, -1).long()[:, t].cpu()
    start, end = int(p[paged._KV_START]), int(p[paged._KV_END])
    span = end - start
    hnd = kw["kv_layout"] == TensorLayout.HND
    pages = (kv_idx.long().cpu()[int(p[paged._KV_PAGE_START])
                                 + torch.arange(-(-span // PS))]
             + kw["kv_indices_offset"])

    def gather(cache):
        g = cache.cpu()[pages]
        g = g[:, h] if hnd else g[:, :, h]
        return g.reshape(-1, g.shape[-1])[:span].double()

    k, v = gather(kc), gather(vc) * v_scale
    qr = q[h, int(p[paged._QO_START]) + r].cpu().double()
    scale = kw["sm_scale"] * k_scale * paged._LOG2E
    s = (k @ qr) * scale
    # float32 S: a sum of D exact products in any order, times the scale
    band = (k.abs() @ qr.abs()) * scale * (D + 2) * 2.0 ** -24 + 2.0 ** -21
    if kw["causal"]:
        q_tok = int(p[paged._Q_POS_BASE]) + (
            int(p[paged._QO_TILE]) * kw["tile_q"] + r) // kw["group"]
        seen = start + torch.arange(span) <= q_tok
        s, band = s[seen], band[seen]
        k, v = k[seen], v[seen]
    m = torch.ceil(s.max())
    p64 = torch.exp2(s - m)
    l64 = p64.sum()
    o64 = p64 @ v / l64
    lo, hi = bf16(torch.exp2(s - m - band)), bf16(torch.exp2(s - m + band))
    open_ = torch.nonzero(lo != hi).flatten()
    moves = (hi - lo)[open_] * v[open_].abs().amax(1)
    open_ = open_[torch.argsort(moves, descending=True)[:OPEN_KEYS]]
    base = bf16(p64)
    choices = []
    for pick in itertools.product((0, 1), repeat=len(open_)):
        pb = base.clone()
        if len(open_):
            pb[open_] = torch.where(torch.tensor(pick, dtype=torch.bool),
                                    hi[open_], lo[open_])
        choices.append(pb)
    preds = torch.stack(choices) @ v / l64  # [choices, dv]
    fits = {}
    for who, o in (("kernel", o_k), ("plain", o_p)):
        steps = half_steps(o.cpu().double()[None], preds).amax(1)
        best = int(torch.argmin(steps))
        fits[who] = (best, float(steps[best]),
                     float(half_steps(o.cpu().double(), preds[0]).max()))
    kb, pb_ = choices[fits["kernel"][0]], choices[fits["plain"][0]]
    return dict(
        keys=len(s), open_keys=int((lo != hi).sum()),
        keys_rounded_apart=int((kb != pb_).sum()),
        o64=float(o64[c]), kernel=float(o_k[c]), plain=float(o_p[c]),
        kernel_vs_o64=float(ratio(o_k[c].cpu(), o64[c])),
        plain_vs_o64=float(ratio(o_p[c].cpu(), o64[c])),
        one_step_bound=float(((hi - lo)[lo != hi].abs()
                              * v[lo != hi, c].abs()).sum() / l64),
        kernel_fit=fits["kernel"][1], plain_fit=fits["plain"][1],
        kernel_fit_exact_rounding=fits["kernel"][2],
        plain_fit_exact_rounding=fits["plain"][2])


def witness(seeds, reps):
    rows = []
    for (mode, tile_q, layout), seed in itertools.product(SHAPES,
                                                          range(seeds)):
        args, kw = draw(mode, tile_q, layout, seed)
        row = dict(case=f"{mode}-{tile_q}-{layout}", seed=seed)
        for fold, unit in (("unfolded", 1.0), ("folded", tc.INT8_UNIT)):
            ks, vs = 0.7 * unit, 1.3 * unit
            kws = dict(kw, k_scale=ks, v_scale=vs)
            ko = [paged.batch_paged_attention_run(*args, **kws)
                  for _ in range(reps)]
            po = [paged.paged_attention_plain(*args, **kws)
                  for _ in range(reps)]
            same = all(torch.equal(a[0], ko[0][0]) and torch.equal(
                a[1], ko[0][1]) for a in ko) and all(
                torch.equal(a[0], po[0][0]) and torch.equal(a[1], po[0][1])
                for a in po)
            rat = ratio(ko[0][0], po[0][0])
            worst = float(rat.max())
            row[fold] = dict(bit_identical=same, ratio=worst,
                             elements_over=int((rat > 1).sum()))
            if fold == "unfolded" and worst > 1:
                t, h, r, c = np.unravel_index(int(torch.argmax(rat)),
                                              tuple(rat.shape))
                row["at"] = [int(t), int(h), int(r), int(c)]
                row.update(row_witness(
                    args, kw, ks, vs, t, h, r, c,
                    ko[0][0][t, h, r].double(), po[0][0][t, h, r].double()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def sweeps(n):
    dev = torch.device("cuda")
    cases = [(qdt, kv, layout, mode, tile_q)
             for mode, tile_q in (("decode", None), ("prefill", 16),
                                  ("prefill", 64))
             for layout in ("NHD", "HND")
             for kv in ("model", "e4m3", "int8")
             for qdt in (torch.float32, torch.bfloat16)]
    fails = {}
    for i in range(n):
        torch.cuda.manual_seed(i)
        for qdt, kv, layout, mode, tile_q in cases:
            name = f"{mode}-{tile_q}-{layout}-{kv}-{str(qdt)[6:]}"
            try:
                tc.test_paged_kernel_matches_plain(dev, qdt, kv, layout,
                                                   mode, tile_q)
            except Exception as e:  # noqa: BLE001 (every failure is shown)
                fails[name] = fails.get(name, 0) + 1
                msg = " / ".join(str(e).splitlines()[:4])
                print(f"sweep {i} {name}: {type(e).__name__}: {msg}",
                      flush=True)
    return dict(sweeps=n, cases=len(cases), failures=fails)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=60)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "paged_int8_witness.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sweep = sweeps(args.sweeps)
    print("SWEEPS " + json.dumps(sweep), flush=True)
    rows = witness(args.seeds, args.reps)
    failed = [r for r in rows if r["unfolded"]["ratio"] > 1]
    summary = dict(
        inputs=len(rows), failed_unfolded=len(failed),
        failed_folded=sum(r["folded"]["ratio"] > 1 for r in rows),
        worst_folded=max(r["folded"]["ratio"] for r in rows),
        not_bit_identical=sum(not (r["unfolded"]["bit_identical"]
                                   and r["folded"]["bit_identical"])
                              for r in rows),
        worst_fit=max((max(r["kernel_fit"], r["plain_fit"])
                       for r in failed), default=None))
    print("SUMMARY " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, sweeps=sweep, summary=summary, rows=rows),
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
