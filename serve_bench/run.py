"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 serve_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--order-seed <n>`` serves the cell's mix in another order of the same
sizes and gaps (its ``order_seed`` replaced): a check that a change holds
beyond the one order the cell is measured on.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and traced seconds
and a breakdown. Either way the served tokens of a sample of requests are
judged against the plain float32 reference after the window (``correct``),
and the numbers compared are printed beside their limits as the last lines
of standard error and under ``checks``, the line's last key.

The run needs as many CUDA devices as the cell names and stops without a
result when they are missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "flashinfer_tpu", "bench", "benchmarks")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``; ``flashinfer_tpu_torch`` is not ``flashinfer_tpu``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _env() -> None:
    # caches at fixed places inside the checkout (nothing here uses Triton
    # today; the nvcc libraries stay in the port's own _build folder)
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def run_cell(reg, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, hook=None,
             order_seed=None) -> dict:
    """The result line of one run (``checks`` last)."""
    import torch

    from serve_bench import check
    from serve_bench.reference import mistral
    from serve_bench.serve import Session, log

    dev = torch.device(device)
    sess = Session(reg, name, seed, dev, trace, T_START, overrides, hook,
                   BENCH_DIR / "out", order_seed)
    sess.warm_up()
    run = sess.measure(seconds)
    log(f"window {run.window_s:.2f} s: {run.tokens} tokens, "
        f"{len(run.steps)} steps, {run.counters['captures']} captures, "
        f"{run.traced_s:.2f} s traced, KV pages in use at most "
        f"{run.kv_pages_peak} of {sess.eng.cfg.num_pages}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for spec in reg.metrics_of(kind, name):
        value = reg.metric(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    served = sess.served()
    attempted, failed = sess.attempted(), sess.failed
    cfg = sess.eng.cfg
    sample_rule = sess.cell["check"]
    pick = check.pick_sample(served, seed, sample_rule["min_tokens"],
                             sample_rule["max_requests"])
    seqs = [served[i].prompt + served[i].output for i in pick]
    outs = [served[i].output for i in pick]
    starts = [len(served[i].prompt) for i in pick]
    sess.free()
    t = time.perf_counter()
    gap = None  # no request to compare: not correct
    if pick:
        ref = mistral.logits(sess.m, seed, seqs, starts, dev)
        gap = check.served_gap(ref, outs, cfg.top_k, cfg.top_p,
                               cfg.temperature)
        del ref
    checks = {"served_gap": (gap, sample_rule["served_gap"])}
    log(f"reference over {len(pick)} requests, {sum(map(len, outs))} served "
        f"tokens, {sum(map(len, seqs))} positions: "
        f"{time.perf_counter() - t:.1f} s")
    correct = failed == 0 and all(
        v is not None and v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = sum(s.busy_s for s in run.slices)
        out["device"]["window_s"] = sum(s.wall_s for s in run.slices)
        out["breakdown"] = _breakdown(run.slices)
    out["sample"] = {"requests": len(pick),
                     "served_tokens": sum(map(len, outs))}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def _breakdown(slices) -> dict:
    fam, idle = {}, {}
    for s in slices:
        for k, v in s.by_family.items():
            fam[k] = fam.get(k, 0.0) + v
        for k, v in s.idle_by_span.items():
            idle[k] = idle.get(k, 0.0) + v

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]

    return {"device_ops": top(fam), "idle_gaps": top(idle)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--order-seed", type=int, default=None)
    args = ap.parse_args(argv)
    _env()
    from serve_bench.registry import Registry

    reg = Registry(ROOT, BENCH_DIR)
    chips = reg.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace), order_seed=args.order_seed)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    from serve_bench.check import format_checks

    checks = {k: (v["value"], v["limit"])
              for k, v in result["checks"].items()}
    for line in format_checks(checks):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
