"""The benchmark's own reader of torch.profiler traces.

A traced run profiles fixed slices of steps (chosen by step count, spread
over the window). Each slice is one ``torch.profiler.profile`` session over
a ``bench.slice`` span that ends after a device synchronise. Once it
stops, its Chrome trace is written under the benchmark's ``out/`` folder,
read, and deleted, while the window's clock stands still (``serve.py``).
Kept unread until a later session had run, a session's trace lost kernels
(an H100, torch 2.11), so each is read as it stops. From it
come the device intervals (kernels, copies, sets), device seconds
by kernel family, and the idle stretches of the device, each labelled by
the innermost ``bench.*`` span the host was in.

The family table is the port's smoke script's (``chip_smoke._family``),
copied so that the yardstick does not move with the program.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from serve_bench.stats import gaps, union_length

FAMILIES = (
    ("paged_attention", ("paged_tc_kernel", "paged_dec_kernel",
                         "paged_f32_kernel", "paged_walk_kernel")),
    ("flash_attention", ("flash_tc_kernel", "flash_f32_kernel",
                         "merge_splits_kernel")),
    ("mla_attention", ("mla_attention_kernel", "mla_dec_kernel",
                       "mla_pre_kernel")),
    ("grouped_gemm", ("grouped_gemm",)),
    ("sampler_family", ("family_cluster_kernel", "family_stream_kernel")),
    ("rmsnorm", ("rmsnorm",)),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")),
    ("copies", ("memcpy", "memset")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def span(name: str, on: bool):
    """A host span the trace records (``bench.<name>``); nothing when the
    run is not traced."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function("bench." + name)


class Slice:
    """What one traced slice holds: its wall (trace clock, seconds),
    device busy seconds, seconds by family and idle seconds by host span."""

    def __init__(self, wall_s: float, busy_s: float,
                 by_family: Dict[str, float], idle_by_span: Dict[str, float]):
        self.wall_s = wall_s
        self.busy_s = busy_s
        self.by_family = by_family
        self.idle_by_span = idle_by_span


def read_chrome_trace(path: Path) -> Optional[Slice]:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name if cat == "kernel" else cat))
        elif cat == "user_annotation" and name.startswith("bench."):
            if name == "bench.slice":
                window = (ts, ts + dur)
            else:
                host.append((ts, ts + dur, name))
    if window is None:
        return None
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in dev
               if e > w0 and s < w1]
    by_family: Dict[str, float] = collections.defaultdict(float)
    for s, e, n in clipped:
        by_family[family(n)] += (e - s) * 1e-6
    ivs = [(s, e) for s, e, _ in clipped]
    idle: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps(ivs, w0, w1):
        # split the gap where a host span starts or ends inside it, and
        # give each piece to the innermost span around it
        cuts = sorted({g0, g1} | {t for h in host for t in h[:2]
                                  if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [h for h in host if h[0] <= mid < h[1]]
            label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
                else "bench.slice"
            idle[label] += (b - a) * 1e-6
    return Slice((w1 - w0) * 1e-6, union_length(ivs) * 1e-6,
                 dict(by_family), dict(idle))


class Tracer:
    """Profiles steps ``start + k * every`` .. ``+ length - 1`` of the
    window (k = 0 .. count - 1)."""

    def __init__(self, out_dir: Path, start: int = 50, every: int = 300,
                 length: int = 10, count: int = 5):
        self.out_dir = out_dir
        self.starts = {start + k * every for k in range(count)}
        self.length = length
        self.slices: List[Slice] = []
        self._prof = None
        self._span = None
        self._end = -1

    def warm(self, step_fn) -> None:
        """One profiled call outside the window: the profiler's first
        session sets itself up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            step_fn()
            torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        """Whether a slice is being profiled."""
        return self._prof is not None

    def before(self, k: int) -> bool:
        """Start a slice at step ``k`` if one starts there; whether it did."""
        if k not in self.starts:
            return False
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = span("slice", True)
        self._span.__enter__()
        self._end = k + self.length - 1
        return True

    def after(self, k: int) -> bool:
        """Stop the slice if step ``k`` is its last; whether it did."""
        if self._prof is None or k < self._end:
            return False
        self.close()
        return True

    def close(self) -> None:
        """Stop the open slice's session and read its trace."""
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
        finally:
            if path.exists():
                os.unlink(path)
        if sl is not None:
            self.slices.append(sl)
        self._prof = self._span = None
