"""Readings that set a cell's limits: the number ``correct`` compares, on
many seeds, at the cell's own load.

    python3 serve_bench/readings.py --workload <name> --seeds 1,2,3 --seconds 20 [--control]

Without ``--control`` one process builds the engine once and, for each
seed, draws that seed's weights into the engine's tensors, serves the
cell's traffic for a short warm-up and a window of ``--seconds``, and keeps
a sample of the served requests; after the last seed the engine is freed
and the reference judges every sample. With ``--control`` each seed is a
whole run of the cell with the engine settings of the cell's
``check.control``: the program's own e4m3 paths, the precision below the
configuration's bf16 (the control that must come out not correct). Prints
one JSON line of readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from serve_bench import run as R  # noqa: E402

def program_readings(reg, name, seeds, seconds):
    import torch

    from serve_bench import check
    from serve_bench.reference import mistral
    from serve_bench.serve import Session, log

    dev = torch.device("cuda")
    sess = Session(reg, name, seeds[0], dev, False, time.perf_counter())
    samples = []
    for i, seed in enumerate(seeds):
        if i:
            sess.reseed(seed)
        sess.warm_up(shapes=i == 0)
        sess.measure(seconds)
        served = sess.served()
        rule = sess.cell["check"]
        pick = check.pick_sample(served, seed, rule["min_tokens"],
                                 rule["max_requests"])
        samples.append((seed, [(list(served[j].prompt), list(served[j].output))
                               for j in pick]))
        log(f"seed {seed}: {len(pick)} requests kept")
    cfg = sess.eng.cfg
    sess.free()
    out = {}
    for seed, reqs in samples:
        ref = mistral.logits(sess.m, seed, [p + o for p, o in reqs],
                             [len(p) for p, _ in reqs], dev)
        g = check.gaps_below_kept(ref, [o for _, o in reqs], cfg.top_k,
                                  cfg.top_p, cfg.temperature)
        out[seed] = max(0.0, float(g.max()))
        log(f"seed {seed}: served_gap {out[seed]!r}; {int((g > 0).sum())} "
            f"of {g.numel()} tokens below the kept set; largest "
            f"{sorted(g.tolist())[-5:]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    R._env()
    from serve_bench.registry import Registry

    reg = Registry(R.ROOT, R.BENCH_DIR)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.control:
        out = {}
        for seed in seeds:
            res = R.run_cell(reg, args.workload, seed, args.seconds, False,
                             overrides=reg.cell(args.workload)["check"][
                                 "control"])
            out[seed] = res["checks"]["served_gap"]["value"]
    else:
        out = program_readings(reg, args.workload, seeds, args.seconds)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "served_gap": out}), flush=True)


if __name__ == "__main__":
    main()
