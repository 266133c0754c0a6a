"""The serving engine's own spans and counters, read beside a run of a cell:
where the device's idle time inside ``step()`` goes, how long the host
prepares a step, and how long each request queued.

The port's engine counts the host seconds of each phase of ``step()``
(``eng.phases``: ``"<kind>.<phase>" -> [seconds, entries]``), stamps each
request's ``queue_wait``, and under a profiler session records each phase
as a range ``engine.<kind>.<phase>`` in the trace beside the kernels. This
module reads them, each as ``None`` from an engine that has none:

- ``engine_idle``: a slice's idle device seconds under ``bench.step``, by
  the innermost engine span the host was in (``bench.step`` itself where
  it was in none);
- ``idle_split``: those seconds as shares of the slices' wall: host
  preparation (every phase but ``replay``, ``readback`` and ``capture``),
  the replayed graph (``replay``, ``readback``), captures, and the rest of
  ``bench.step``;
- ``host_seconds``: the host-preparation part of a step's phase seconds;
- ``minus_pauses``: a wait with the tracer's pauses taken out.

Run as a script, it serves one cell as ``run.py`` does, without the
reference check, and prints one JSON line: the cell's metrics (end to end
and per layer) and these readings.

    python3 serve_bench/engine_split.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR.parent))

from serve_bench.stats import gaps, median, percentile  # noqa: E402
from serve_bench.trace import (  # noqa: E402
    DEVICE_CATS,
    Tracer,
    read_chrome_trace,
)

# the phases in which the host does not prepare a step
NOT_HOST = ("replay", "readback", "capture")


def phase_of(label: str) -> str:
    return label.rsplit(".", 1)[-1]


def innermost_idle(idle: Sequence[Tuple[float, float]],
                   spans: Sequence[Tuple[float, float, str]]
                   ) -> Dict[str, float]:
    """Seconds of the idle stretches (trace microseconds) by the innermost
    (shortest) span around each part of them; parts outside every span are
    left out. The same rule as ``read_chrome_trace``'s, by bisection."""
    pts = sorted({t for s, e, _ in spans for t in (s, e)})
    labels: List[Optional[str]] = []
    for a, b in zip(pts, pts[1:]):
        mid = 0.5 * (a + b)
        inner = [h for h in spans if h[0] <= mid < h[1]]
        labels.append(min(inner, key=lambda h: h[1] - h[0])[2]
                      if inner else None)
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in idle:
        i = max(bisect.bisect_right(pts, g0) - 1, 0)
        while i < len(labels) and pts[i] < g1:
            lo, hi = max(g0, pts[i]), min(g1, pts[i + 1])
            if hi > lo and labels[i] is not None:
                out[labels[i]] += (hi - lo) * 1e-6
            i += 1
    return dict(out)


def engine_idle(events: Sequence[dict]) -> Dict[str, float]:
    """Idle device seconds under ``bench.step`` in one slice's trace events,
    by the innermost ``engine.*`` range around them, or ``bench.step``."""
    window = None
    dev: List[Tuple[float, float]] = []
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
        elif cat == "user_annotation":
            if name == "bench.slice":
                window = (ts, ts + dur)
            elif name == "bench.step" or name.startswith("engine."):
                spans.append((ts, ts + dur, name))
    if window is None:
        return {}
    w0, w1 = window
    ivs = [(max(s, w0), min(e, w1)) for s, e in dev if e > w0 and s < w1]
    return innermost_idle(gaps(ivs, w0, w1), spans)


def idle_in_step(slices) -> Dict[str, float]:
    """Idle seconds under ``bench.step`` over the slices, by label."""
    idle: Dict[str, float] = collections.defaultdict(float)
    for s in slices:
        for k, v in getattr(s, "idle_by_engine", {}).items():
            idle[k] += v
    return dict(idle)


def idle_split(slices) -> Optional[Dict[str, float]]:
    """Idle shares (%) of the slices' wall: ``host``, ``replay``,
    ``capture``, ``outside`` (``bench.step`` outside every engine span),
    and ``outside_of_step`` (that over all idle under ``bench.step``).
    None where no slice holds an engine span."""
    idle = idle_in_step(slices)
    wall = sum(s.wall_s for s in slices)
    if wall <= 0 or not any(k.startswith("engine.") for k in idle):
        return None
    part = collections.defaultdict(float)
    for k, v in idle.items():
        if not k.startswith("engine."):
            part["outside"] += v
        elif phase_of(k) == "capture":
            part["capture"] += v
        else:
            part["replay" if phase_of(k) in NOT_HOST else "host"] += v
    out = {k: 100.0 * part[k] / wall
           for k in ("host", "replay", "capture", "outside")}
    out["outside_of_step"] = 100.0 * part["outside"] / sum(idle.values())
    return out


def host_seconds(seconds: Dict[str, float]) -> float:
    """The host-preparation part of seconds by phase key."""
    return sum(v for k, v in seconds.items() if phase_of(k) not in NOT_HOST)


def minus_pauses(t0: float, t1: float,
                 pauses: Sequence[Tuple[float, float]]) -> float:
    """t1 - t0 less the parts of ``pauses`` inside [t0, t1)."""
    return t1 - t0 - sum(max(0.0, min(t1, b) - max(t0, a))
                         for a, b in pauses)


class StepRecorder:
    """Wraps an engine's ``step`` (``attach`` is a ``Session`` hook): from
    ``start()`` on, each call's start on the raw clock and the change of
    each phase counter's seconds (None for an engine without counters)."""

    def __init__(self):
        self.on = False
        self.calls: List[Tuple[float, Optional[Dict[str, float]]]] = []
        self._phases: Optional[dict] = None
        self._last: Dict[str, float] = {}

    def _seconds(self) -> Dict[str, float]:
        return {k: v[0] for k, v in self._phases.items()}

    def attach(self, eng) -> None:
        step = eng.step
        self._phases = getattr(eng, "phases", None)

        def recorded():
            if not self.on:
                return step()
            t0 = time.perf_counter()
            out = step()
            delta = None
            if self._phases is not None:
                now, last = self._seconds(), self._last
                delta = {k: v - last.get(k, 0.0) for k, v in now.items()
                         if v != last.get(k, 0.0)}
                self._last = now
            self.calls.append((t0, delta))
            return out

        eng.step = recorded

    def start(self) -> None:
        self.calls.clear()
        if self._phases is not None:
            self._last = self._seconds()
        self.on = True


class EngineTracer(Tracer):
    """The benchmark's tracer, each slice also read by engine span
    (``Slice.idle_by_engine``), and the raw-clock intervals in which it
    held the window's clock still (``pauses``)."""

    def __init__(self, out_dir: Path):
        super().__init__(out_dir)
        self.pauses: List[Tuple[float, float]] = []

    def before(self, k: int) -> bool:
        t = time.perf_counter()
        started = super().before(k)
        if started:
            self.pauses.append((t, time.perf_counter()))
        return started

    def after(self, k: int) -> bool:
        t = time.perf_counter()
        stopped = super().after(k)
        if stopped:
            self.pauses.append((t, time.perf_counter()))
        return stopped

    def close(self) -> None:
        """``Tracer.close``, the trace also read by engine span."""
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "slice_trace.json"
        try:
            self._prof.export_chrome_trace(str(path))
            sl = read_chrome_trace(path)
            if sl is not None:
                with open(path) as f:
                    sl.idle_by_engine = engine_idle(
                        json.load(f).get("traceEvents", []))
        finally:
            if path.exists():
                os.unlink(path)
        if sl is not None:
            self.slices.append(sl)
        self._prof = self._span = None


def _decode_only(s) -> bool:
    """The steps ``decode_step_ms`` reads, traced or not."""
    return s.prefill_replays == 0 and s.decode_rows > 0


def readings(run, calls, waits: Optional[List[float]]) -> dict:
    """The engine's readings over a window: ``run`` its ``Run``, ``calls``
    the ``StepRecorder``'s calls (one a window step), ``waits`` the queue
    seconds of the requests first admitted in it (None: not stamped)."""
    if len(calls) != len(run.steps):
        raise ValueError(f"{len(calls)} recorded calls, "
                         f"{len(run.steps)} window steps")
    out: dict = {"decode_host_ms": None, "queue_wait_p95_ms": None,
                 "idle_split": idle_split(run.slices)}
    if out["idle_split"] is not None:
        out["idle_in_step"] = sorted(idle_in_step(run.slices).items(),
                                     key=lambda kv: -kv[1])
    if waits:
        out["queue_wait_p95_ms"] = percentile(waits, 95) * 1e3
        out["queue_wait_median_ms"] = median(waits) * 1e3
    for traced in (False, True):
        deltas = [d for s, (_, d) in zip(run.steps, calls)
                  if s.traced == traced and _decode_only(s)
                  and d is not None]
        if not deltas:
            continue
        keys = sorted({k for d in deltas for k in d})
        name = "traced" if traced else "untraced"
        out[f"phase_ms_{name}"] = {
            k: 1e3 * sum(d.get(k, 0.0) for d in deltas) / len(deltas)
            for k in keys}
        out[f"decode_steps_{name}"] = len(deltas)
        if not traced:
            out["decode_host_ms"] = median(
                [1e3 * host_seconds(d) for d in deltas])
    return out


def measure(reg, name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    import torch

    from serve_bench import run as R
    from serve_bench.serve import Session, log

    rec = StepRecorder()
    sess = Session(reg, name, seed, torch.device(device), trace, R.T_START,
                   hook=rec.attach, out_dir=BENCH_DIR / "out")
    if trace:
        sess.tracer = EngineTracer(BENCH_DIR / "out")
    sess.warm_up()
    eng = sess.eng
    deferred = dict(getattr(eng, "deferred", {}))
    rec.start()
    run = sess.measure(seconds)
    rec.on = False
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        for spec in reg.metrics_of(kind, name):
            value = reg.metric(spec["name"]).read(run)
            if value is not None:
                metrics[spec["name"]] = value
    waits = None
    if run.steps and hasattr(eng, "deferred"):
        first = rec.calls[0][0]  # no step has run since the window
        pauses = sess.tracer.pauses if trace else []
        waits = [minus_pauses(tr.gen.queued_at,
                              tr.gen.queued_at + tr.gen.queue_wait, pauses)
                 for tr in sess.tracks.values()
                 if tr.gen.queue_wait is not None
                 and tr.gen.queued_at + tr.gen.queue_wait >= first]
    out = {"workload": name, "seed": seed, "trace": int(trace),
           "device": (torch.cuda.get_device_name(0)
                      if device == "cuda" else device),
           "window_s": run.window_s, "tokens": run.tokens,
           "steps": len(run.steps), "metrics": metrics,
           **readings(run, rec.calls, waits)}
    if hasattr(eng, "deferred"):
        out["deferred"] = {k: v - deferred[k]
                           for k, v in eng.deferred.items()}
    log(f"engine split: {json.dumps(out)}")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from serve_bench import run as R
    from serve_bench.registry import Registry

    R._env()
    reg = Registry(R.ROOT, BENCH_DIR)
    out = measure(reg, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
