"""The one traffic generator: a mix is a data file (``traffic/<name>.json``)
of parameters, and this module turns it and a seed into requests.

Every seed gets the same multiset of sizes and gaps: lengths and
inter-arrival gaps are the quantiles of their distributions at
(i + 0.5) / n, shuffled by the mix's own ``order_seed`` (one order for the
window, another for the warm-up). The run's seed draws only the token ids:
the order decides how arrivals bunch, and with it a tail, so a seed that
reordered them would change the work.

Mix keys:

* ``order_seed``: the seed of the mix's order of sizes and gaps.
* ``arrivals``: the name of an arrival process, ``arrivals/<name>.py``,
  whose ``due_times(mix, seconds, rate, rng)`` gives the due times of a
  phase: ``poisson`` (open loop at the cell's ``rate_per_s``) or
  ``closed`` (``sessions`` requests, all present from the start). A new
  process is a new file.
* ``prompt`` and ``output``: a length distribution, ``{"dist":
  "lognormal", "median", "sigma", "min", "max"}`` or ``{"dist":
  "uniform", "min", "max"}``; ``output`` may be ``{"dist": "fill"}``: as
  many tokens as the cell's ``max_seq_len`` leaves after the prompt.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import statistics
from pathlib import Path
from types import ModuleType
from typing import List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Request:
    due_s: float  # seconds after the start of its phase
    prompt: np.ndarray  # int64 token ids
    max_new_tokens: int


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(x) for x in u])
        vals = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        vals = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(vals), dist["min"], dist["max"]).astype(np.int64)


def arrival_process(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The arrival process ``arrivals/<name>.py`` of a bench folder."""
    path = Path(bench_dir) / "arrivals" / f"{name}.py"
    if not path.exists():
        raise ValueError(f"unknown arrivals {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"serve_bench_arrivals_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_requests(mix: dict, seed: int, seconds: float, rate: float,
                  vocab: int, max_seq_len: int,
                  phase: str = "window",
                  bench_dir: Path = BENCH_DIR) -> List[Request]:
    """The requests of one phase of ``seconds``, due when the mix's arrival
    process says. The same seed gives the same requests."""
    ids = np.random.default_rng(seed)
    rng = np.random.default_rng([mix["order_seed"],
                                 ("window", "warmup").index(phase)])
    due = np.asarray(arrival_process(mix["arrivals"], bench_dir).due_times(
        mix, seconds, rate, rng), dtype=np.float64)
    n = len(due)
    prompts = rng.permutation(_quantiles(mix["prompt"], n))
    if mix["output"]["dist"] == "fill":
        outputs = max_seq_len - prompts
    else:
        outputs = rng.permutation(_quantiles(mix["output"], n))
    if (prompts + outputs).max() > max_seq_len:
        raise ValueError("a request of the mix exceeds the cell's "
                         f"max_seq_len {max_seq_len}")
    return [Request(float(d), ids.integers(0, vocab, int(p)), int(o))
            for d, p, o in zip(due, prompts, outputs)]


def derived_seed(seed: int, purpose: str) -> int:
    """A seed for another purpose (the warm-up's traffic), fixed by the
    run's seed and never equal to it."""
    h = 1469598103934665603
    for ch in f"{seed}/{purpose}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h if h != seed else h + 1

