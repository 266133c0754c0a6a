"""CUDA graphs of a fixed-shape device step.

PyTorch's counterpart of the JAX engines' jitted steps: JAX compiles a step
once per static shape, here a step is captured once per key into a
``torch.cuda.CUDAGraph`` and replayed. A key is any hashable; a tuple whose
first item is a string names the step's kind (the Llama engine's
``("prefill", PlanMeta)``, ``("score", PlanMeta)``, ``("verify",
PlanMeta)``), any other key is of kind "step" (its decode step's and the
dp x tp engine's ``PlanMeta``). Every graph reads one static input buffer
of its own, which the caller fills before each replay. Graphs whose
outputs have one shape and dtype write one shared output tensor (a
``score()`` bucket's f32 logits are 0.5 GB at 1024 rows), so an output
is valid until the next replay: callers read it at once. All graphs
share one memory pool for their intermediates, which is safe because
replays run one at a time on one stream and nothing inside the pool
outlives a replay.

A capture warms the step up eagerly on a side stream first: the kernels
build at their first call (``flashinfer_tpu_torch.jit``), and a build must
not happen inside a capture. Python's cyclic garbage collector is paused
while a graph is captured: an unreachable engine it collected there would
free its CUDA graphs and memory inside the capture and invalidate it. A
failed capture or replay raises; nothing falls back to the eager step.

Launch counts: a capture records launches without running them, and each
replay runs them all. So a capture takes back the counts its wrappers added,
and every replay adds them again (``batch_paged_attention_run.launches``, its
``gather_launches`` and the other wrappers' counts then say how many
kernels ran). ``stats`` keeps, for each kind, the captures, their seconds
and the replays. Each capture is also a span ``engine.<kind>.capture``
(``flashinfer_tpu_torch.profiler.annotate``) that counts into ``phases``
(the caller's dict, as the Llama engine's ``phases``).

A step may run collectives of ``torch.distributed`` (NCCL captures them
on the capturing stream); its communicator must exist before the
capture, which the eager warm-up's collectives see to.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged_merge import (
    paged_merge,
)
from flashinfer_tpu_torch.ops.attention.mla import mla_paged_run
from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded
from flashinfer_tpu_torch.ops.norm import rmsnorm
from flashinfer_tpu_torch.ops.sampling import family_call
from flashinfer_tpu_torch.profiler import annotate

__all__ = ["StepGraphs", "kind_of"]

# every launch count of the kernel wrappers: (wrapper, attribute)
_COUNTED = tuple((f, "launches") for f in (
    batch_paged_attention_run, paged_merge, family_call, rmsnorm,
    mla_paged_run, grouped_gemm_padded, flash_attention_dense)) + (
    (batch_paged_attention_run, "gather_launches"),)


def _counts() -> List[int]:
    return [getattr(f, a) for f, a in _COUNTED]


def _add(counts: List[int], sign: int) -> None:
    for (f, a), n in zip(_COUNTED, counts):
        setattr(f, a, getattr(f, a) + sign * n)


Step = Callable[[torch.Tensor, Hashable], torch.Tensor]


def kind_of(key: Hashable) -> str:
    """The kind a key names: its first item where that is a string."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return "step"


class StepGraphs:
    """One CUDA graph per key over a step ``step(buf, key) -> tensor``.

    ``inputs(key, n)`` is the key's static input buffer (int32, n values);
    ``run(key, step)`` replays the key's graph (capturing ``step`` on first
    use) and returns the static output. With ``enabled`` False (or a CPU
    device), ``run`` calls the step eagerly on the same buffer.
    """

    def __init__(self, device: torch.device, enabled: bool,
                 phases: Optional[dict] = None):
        self.device = device
        self.enabled = enabled and device.type == "cuda"
        self._bufs: Dict[Hashable, torch.Tensor] = {}
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph,
                                           torch.Tensor, List[int]]] = {}
        # the outputs, one a (shape, dtype)
        self._outs: Dict[tuple, torch.Tensor] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.enabled else None
        # growth of the reserved device memory over the captures
        self.pool_bytes = 0
        self.last_key = None  # the key of the last step run
        # kind -> captures, capture seconds, replays
        self.stats: Dict[str, Dict[str, float]] = {}
        # "<kind>.capture" -> [seconds, captures] of the capture spans
        self.phases = {} if phases is None else phases

    @property
    def captures(self) -> int:
        return len(self._graphs)

    @property
    def capture_seconds(self) -> float:
        return sum(v["capture_s"] for v in self.stats.values())

    @property
    def output_bytes(self) -> int:
        """Bytes of the shared output tensors (outside the pool)."""
        return sum(t.numel() * t.element_size() for t in self._outs.values())

    def _stat(self, key: Hashable) -> Dict[str, float]:
        return self.stats.setdefault(
            kind_of(key), dict(captures=0, capture_s=0.0, replays=0))

    def inputs(self, key: Hashable, n: int) -> torch.Tensor:
        if key not in self._bufs:
            self._bufs[key] = torch.zeros(n, dtype=torch.int32,
                                          device=self.device)
        return self._bufs[key]

    def run(self, key: Hashable, step: Step) -> torch.Tensor:
        buf = self._bufs[key]
        self.last_key = key
        if not self.enabled:
            return step(buf, key)
        if key not in self._graphs:
            self._graphs[key] = self._capture(buf, key, step)
        return self.replay(key)

    def replay(self, key: Hashable) -> torch.Tensor:
        """Replay the key's graph once on its buffer as it stands."""
        graph, out, launched = self._graphs[key]
        graph.replay()
        _add(launched, 1)
        self._stat(key)["replays"] += 1
        return out

    def _capture(self, buf, key, step: Step):
        span = kind_of(key) + ".capture"
        with annotate("engine." + span, self.phases, span):
            t0 = time.perf_counter()
            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                # warm-up: builds the kernels, sets up cuBLAS and the
                # communicators; the step rewrites the same cache entries
                # when the graph replays
                res = step(buf, key)
                spec = (tuple(res.shape), res.dtype)
                if spec not in self._outs:
                    self._outs[spec] = res.clone()
                out = self._outs[spec]
                del res
            stream.wait_stream(side)
            torch.cuda.synchronize(self.device)
            gc.collect()  # before the reading: the capture empties the cache
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    out.copy_(step(buf, key))
            finally:
                gc.enable()
            launched = [a - b for a, b in zip(_counts(), before)]
            _add(launched, -1)  # recorded, not run
            self.pool_bytes += (torch.cuda.memory_reserved(self.device)
                                - reserved)
            stat = self._stat(key)
            stat["captures"] += 1
            stat["capture_s"] += time.perf_counter() - t0
            return graph, out, launched
