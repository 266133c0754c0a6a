"""Run-time tactic tuner.

Counterpart of ``flashinfer_tpu/autotuner.py`` (the reference's
``flashinfer/autotuner.py``): ``AutoTuner.choose_one`` times each tactic of
a ``TunableRunner`` on the device, keeps the winner per (op, shape) key and
persists it to ``get_config_path()`` under the cache directory;
``autotune()`` switches timing on. Outside an ``autotune()`` region
``choose_one`` returns the persisted winner, or the first tactic, without
timing anything.

A tactic here is a launch choice the port's kernels really have. Two call
sites consult the tuner, the counterparts of JAX's two: the rows a work
item of a paged prefill plan (``ops/attention/batch.py``; JAX tunes the
paged kernel's VMEM tiles) and of an MLA prefill plan
(``ops/attention/mla.py``; JAX tunes MLA's ``tile_k``). Both are planned on
the host, so a winner is read when a wrapper plans, and timing a tactic
plans the batch again with it (``tune_replanned``), timed by
``testing.bench_gpu_time_differential`` over CUDA-graph replays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, Optional, Sequence

from flashinfer_tpu_torch.jit.env import CACHE_DIR, logger

__all__ = ["AutoTuner", "TunableRunner", "autotune", "get_config_path",
           "tune_replanned"]


def get_config_path() -> str:
    """The persisted winners (JSON, op key -> tactic)."""
    return str(CACHE_DIR / "autotuner_configs.json")


class TunableRunner:
    """A tunable op: its valid tactics, and a run of one."""

    def get_valid_tactics(self) -> Sequence[Any]:
        raise NotImplementedError

    def run(self, tactic: Any, *args):
        raise NotImplementedError


@dataclasses.dataclass
class _Stats:
    tuned_ops: int = 0
    profiled_tactics: int = 0
    cache_hits: int = 0


def _tactic_key(t: Any) -> str:
    return json.dumps(t, sort_keys=True, default=str)


class AutoTuner:
    """The process's tactic selector (``AutoTuner.get()``)."""

    _instance: Optional["AutoTuner"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.enabled = False
        self._cache: Dict[str, Any] = {}
        self.stats = _Stats()
        self._loaded = False

    @classmethod
    def get(cls) -> "AutoTuner":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        path = get_config_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._cache.update(json.load(f))
            except (OSError, ValueError) as e:
                logger.warning("autotuner config %s unreadable: %s", path, e)

    def _save(self):
        path = get_config_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._cache, f, indent=1, default=str)
        os.replace(tmp, path)

    def cached(self, op_key: str, tactics: Sequence[Any]) -> Optional[Any]:
        """The persisted winner for ``op_key`` if it is still one of
        ``tactics``, else None. A host lookup, no timing."""
        self._load()
        want = self._cache.get(op_key)
        if want is not None:
            for t in tactics:
                if _tactic_key(t) == want:
                    self.stats.cache_hits += 1
                    return t
        return None

    def choose_one(
        self,
        op_key: str,
        runner: TunableRunner,
        *args,
        time_tactic: Optional[Callable[[Any], float]] = None,
    ) -> Any:
        """The best tactic for ``op_key``: the persisted winner; else,
        inside ``autotune()``, the fastest by ``time_tactic`` (default:
        ``bench_gpu_time`` of ``runner.run(tactic, *args)``), persisted;
        else the first valid tactic."""
        self._load()
        tactics = list(runner.get_valid_tactics())
        if not tactics:
            raise ValueError(f"{op_key}: no valid tactics")
        cached = self.cached(op_key, tactics)
        if cached is not None:
            return cached
        if not self.enabled:
            return tactics[0]

        from flashinfer_tpu_torch.testing.utils import bench_gpu_time

        best, best_t = None, float("inf")
        for tactic in tactics:
            try:
                if time_tactic is not None:
                    dt = time_tactic(tactic)
                else:
                    dt = bench_gpu_time(
                        lambda *a: runner.run(tactic, *a), *args, warmup=2,
                        repeats=5, reducer="min")
            except (RuntimeError, ValueError) as e:  # refused on this card
                logger.info("%s: tactic %s failed (%s)", op_key, tactic, e)
                continue
            self.stats.profiled_tactics += 1
            if dt < best_t:
                best, best_t = tactic, dt
        if best is None:
            raise RuntimeError(f"{op_key}: every tactic failed")
        self._cache[op_key] = _tactic_key(best)
        self.stats.tuned_ops += 1
        self._save()
        return best


@contextlib.contextmanager
def autotune(enable: bool = True):
    """Time tactics (and persist the winners) inside the region."""
    tuner = AutoTuner.get()
    prev = tuner.enabled
    tuner.enabled = enable
    try:
        yield tuner
    finally:
        tuner.enabled = prev


def tune_replanned(op_key: str, tactics: Sequence[Any],
                   replan: Callable[[Any], None],
                   step: Callable[[Any], Any], carry0) -> Any:
    """Choose among plan-time tactics: for each, ``replan(tactic)`` and time
    ``step`` (a chained step, as ``bench_gpu_time_differential`` takes it)
    from ``carry0``; persist the fastest and leave the caller planned with
    it. Returns the winner."""
    from flashinfer_tpu_torch.testing.utils import bench_gpu_time_differential

    class _Planned(TunableRunner):
        def get_valid_tactics(self):
            return tactics

    def time_tactic(tactic):
        replan(tactic)
        return bench_gpu_time_differential(step, carry0, n_short=2,
                                           n_long=10, repeats=3)

    best = AutoTuner.get().choose_one(op_key, _Planned(),
                                      time_tactic=time_tactic)
    replan(best)
    return best
