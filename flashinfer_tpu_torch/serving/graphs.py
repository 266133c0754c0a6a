"""CUDA graphs of a fixed-shape device step.

PyTorch's counterpart of the JAX engine's jitted decode step: JAX compiles
the step once per static shape, here the step is captured once per key
(the engine's key is the step's ``PlanMeta``) into a ``torch.cuda.CUDAGraph``
and replayed. Every graph reads one static input buffer of its own, which
the caller fills before each replay, and writes one static output buffer;
all graphs share one memory pool for their intermediates, which is safe
because replays run one at a time on one stream and nothing inside the
pool outlives a replay.

A capture warms the step up eagerly on a side stream first: the kernels
build at their first call (``flashinfer_tpu_torch.jit``), and a build must
not happen inside a capture. Python's cyclic garbage collector is paused
while a graph is captured: an unreachable engine it collected there would
free its CUDA graphs and memory inside the capture and invalidate it. A
failed capture or replay raises; nothing falls back to the eager step.

Launch counts: a capture records launches without running them, and each
replay runs them all. So a capture takes back the counts its wrappers added,
and every replay adds them again (``batch_paged_attention_run.launches`` and
the other wrappers' counts then say how many kernels ran).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
)
from flashinfer_tpu_torch.ops.attention.mla import mla_paged_run
from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded
from flashinfer_tpu_torch.ops.norm import rmsnorm
from flashinfer_tpu_torch.ops.sampling import family_call

__all__ = ["StepGraphs"]

# every kernel wrapper that counts its launches
_COUNTED = (batch_paged_attention_run, family_call, rmsnorm, mla_paged_run,
            grouped_gemm_padded, flash_attention_dense)


def _counts() -> List[int]:
    return [f.launches for f in _COUNTED]


Step = Callable[[torch.Tensor, Hashable], torch.Tensor]


class StepGraphs:
    """One CUDA graph per key over a step ``step(buf, key) -> tensor``.

    ``inputs(key, n)`` is the key's static input buffer (int32, n values);
    ``run(key, step)`` replays the key's graph (capturing ``step`` on first
    use) and returns the static output. With ``enabled`` False (or a CPU
    device), ``run`` calls the step eagerly on the same buffer.
    """

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = enabled and device.type == "cuda"
        self._bufs: Dict[Hashable, torch.Tensor] = {}
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph,
                                           torch.Tensor, List[int]]] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.enabled else None
        self.capture_seconds = 0.0
        # growth of the reserved device memory over the captures
        self.pool_bytes = 0
        self.last_key = None  # the key of the last step run

    @property
    def captures(self) -> int:
        return len(self._graphs)

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
        for f, n in zip(_COUNTED, launched):
            f.launches += n
        return out

    def _capture(self, buf, key, step: Step):
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            # warm-up: builds the kernels and sets up cuBLAS; the step
            # rewrites the same cache entries when the graph replays
            out = step(buf, key).clone()
        stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out.copy_(step(buf, key))
        finally:
            gc.enable()
        launched = [a - b for a, b in zip(_counts(), before)]
        for f, n in zip(_COUNTED, launched):
            f.launches -= n  # recorded, not run
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds += time.perf_counter() - t0
        return graph, out, launched
