"""The sweep that finds a chat cell's knee: the highest arrival rate the
engine sustains without a growing queue. Run once when a cell is defined;
the cell then offers load at a fixed share of it.

    python3 serve_bench/knee.py --workload <name> --rates 6,8,10,12 --seconds 30 --seed 7

One process: the cell's set-up and warm-up, then each rate in turn for
``--seconds`` (the engine drained between rates). Prints a JSON line a
rate: output tokens/s, TTFT median and p95, requests waiting for their
first token at the half and at the end of the window.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from serve_bench import run as R  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    R._env()
    import torch

    from serve_bench.registry import Registry
    from serve_bench.serve import Session
    from serve_bench.stats import percentile

    reg = Registry(R.ROOT, R.BENCH_DIR)
    sess = Session(reg, args.workload, args.seed, torch.device("cuda"),
                   False, time.perf_counter())
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        sess.cell["rate_per_s"] = rate
        if i:
            while sess.eng.has_work():
                sess.eng.step()
        sess.warm_up(shapes=i == 0)
        run = sess.measure(args.seconds)
        t0 = sess.t0

        def waiting(t):
            return sum(tr.due <= t and (tr.first is None or tr.first > t)
                       for tr in sess.ttft_pending)

        print(json.dumps({
            "rate": rate, "tokens_per_s": run.tokens / run.window_s,
            "ttft_p50_ms": percentile(run.ttft_s, 50) * 1e3,
            "ttft_p95_ms": percentile(run.ttft_s, 95) * 1e3,
            "itl_p95_ms": percentile(run.itl_s, 95) * 1e3,
            "waiting_half": waiting(t0 + args.seconds / 2),
            "waiting_end": waiting(t0 + args.seconds),
            "running_end": sess.eng.num_running,
            "preemptions": run.counters["preemptions"],
            "captures": run.counters["captures"]}), flush=True)


if __name__ == "__main__":
    main()
