"""What the A/B tools (``*_ab.py``) share: each runs one child process a
checkout, in the order given, on one card, and prints a table of the
runs' times.

A child runs with the checkout's root as its working directory, imports
that checkout's ``flashinfer_tpu_torch``, and prints its rows as one line
``ROWS <json list>``; each row has ``case``, ``ms``, ``bound_ms`` and
``bound_by``, and ``ok`` where the child held the kernel to its plain
version. Name a DIR twice for parent / change / change / parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    """This checkout's ``chip_smoke`` (its cases and timers), imported in a
    child whose working directory is the checkout under test."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def parse_args(doc, *extra):
    """DIRs and ``--out``, plus ``extra`` (argparse (flags, options) pairs)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", help="also write every run's rows here (JSON)")
    for flags, options in extra:
        ap.add_argument(*flags, **options)
    return ap.parse_args()


def run(dirs, argv, out=None, label=lambda r: r["case"],
        cell=lambda r: f"{r['ms']:.4f}", columns=()):
    """Runs ``argv`` (after the interpreter) in each DIR and prints the card
    and a table: a row's ``label``, each run's ``cell``, any ``columns``
    ((head, fn of the first run's row)), and the first run's bound. Returns
    the exit code: 1 if a run failed or a row is not ``ok``."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs, bad = [], []
    for d in dirs:
        proc = subprocess.run([sys.executable] + argv, cwd=d,
                              capture_output=True, text=True, timeout=900)
        rows = next((json.loads(ln[5:]) for ln in proc.stdout.splitlines()
                     if ln.startswith("ROWS ")), None)
        if rows is None:
            print(f"run in {d} failed (exit {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            return 1
        name = os.path.basename(os.path.normpath(os.path.abspath(d)))
        bad += [f"{name} {label(r)}" for r in rows if not r.get("ok", True)]
        runs.append((name, rows))
    print(card)
    print(" | ".join(["case"] + [name for name, _ in runs]
                     + [head for head, _ in columns] + ["bound"]))
    for i, r in enumerate(runs[0][1]):
        print(" | ".join([label(r)] + [cell(rows[i]) for _, rows in runs]
                         + [fn(r) for _, fn in columns]
                         + [f"{r['bound_ms']:.5f} ({r['bound_by']})"]))
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=card, runs=runs), f, indent=1)
    if bad:
        print(f"disagree with the plain version: {bad}")
        return 1
    return 0
