"""Trace capture in a Perfetto-loadable form, and a summary of it by kernel.

Counterpart of ``flashinfer_tpu/profiler/__init__.py``. ``profile_trace``
records the enclosed region with ``torch.profiler`` (host ops, and on a
machine with a card every kernel, memcpy and memset the card ran, those
replayed from CUDA graphs too) and writes a Chrome-trace JSON that
ui.perfetto.dev loads. ``annotate`` opens a named span (an NVTX range on the
card, a ``record_function`` range while a profiler session records) and can
count its seconds into a caller's dict. ``summarize_trace`` sums the device
events of the newest trace by kernel name.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import gzip
import json
import os
import shutil
import time
from typing import Iterator, List, Optional, Tuple

import torch

from flashinfer_tpu_torch.jit.env import CACHE_DIR

__all__ = [
    "profile_trace",
    "annotate",
    "export_to_perfetto_trace",
    "latest_trace_path",
    "summarize_trace",
]

DEFAULT_TRACE_DIR = str(CACHE_DIR / "traces")
# the categories torch.profiler gives the card's own events
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(log_dir: str = DEFAULT_TRACE_DIR) -> Iterator[str]:
    """Trace the enclosed region; on exit the trace is written to
    ``log_dir/trace-<time>-<pid>.trace.json`` (the Chrome trace format,
    which Perfetto reads). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


@functools.lru_cache(maxsize=None)
def _nvtx() -> bool:
    return torch.cuda.is_available()


class annotate:
    """A named span around the enclosed code (``with annotate(name):``).

    On the card it is an NVTX range. While a profiler session records on
    this thread it is also a ``record_function`` range, so it lands in the
    session's trace beside the kernels; outside a session none is opened.
    Given ``counters`` (a dict), it adds its seconds and a count to
    ``counters[key]`` (``[seconds, count]``; ``key`` defaults to ``name``)
    whether or not a session records: two ``perf_counter`` reads, the
    range's own cost left out. One object may be entered again once it has
    exited (not while it is open)."""

    __slots__ = ("name", "counters", "key", "_range", "_t0", "_nv")

    def __init__(self, name: str, counters: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name = name
        self.counters = counters
        self.key = name if key is None else key

    def __enter__(self) -> "annotate":
        self._nv = _nvtx()
        if self._nv:
            torch.cuda.nvtx.range_push(self.name)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._nv:
            torch.cuda.nvtx.range_pop()
        c = self.counters
        if c is not None:
            stat = c.get(self.key)
            if stat is None:
                c[self.key] = [seconds, 1]
            else:
                stat[0] += seconds
                stat[1] += 1


def latest_trace_path(log_dir: str = DEFAULT_TRACE_DIR) -> Optional[str]:
    """The newest trace under ``log_dir`` (``*.trace.json`` or
    ``*.trace.json.gz``, at any depth), or None."""
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits.extend(glob.glob(os.path.join(log_dir, "**", pat),
                              recursive=True))
    return max(hits, key=os.path.getmtime) if hits else None


def export_to_perfetto_trace(log_dir: str = DEFAULT_TRACE_DIR,
                             out_path: str = "trace.perfetto.json") -> str:
    """Copy the newest trace under ``log_dir`` to ``out_path`` (open it in
    ui.perfetto.dev); returns ``out_path``."""
    src = latest_trace_path(log_dir)
    if src is None:
        raise FileNotFoundError(
            f"no trace under {log_dir}; wrap the region in profile_trace()")
    shutil.copyfile(src, out_path)
    return out_path


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize_trace(log_dir: str = DEFAULT_TRACE_DIR,
                    top: int = 20) -> List[Tuple[str, float, int]]:
    """[(name, total_ms, count)] of the device events (kernels, memcpys,
    memsets) of the newest trace under ``log_dir``, by name, the largest
    total first; [] for a trace that holds none (a CPU run)."""
    path = latest_trace_path(log_dir)
    if path is None:
        raise FileNotFoundError(f"no trace under {log_dir}")
    total: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in _load(path).get("traceEvents", []):
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") in _DEVICE_CATEGORIES):
            total[e["name"]] += float(e["dur"])
            count[e["name"]] += 1
    return [(name, us / 1e3, count[name])
            for name, us in total.most_common(top)]
