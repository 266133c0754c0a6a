"""A declarative logits-processing pipe, compiled onto the sampler.

Counterpart of ``flashinfer_tpu/logits_processor/__init__.py`` (the
reference's ``flashinfer/logits_processor/``). ``compile_pipeline``
type-checks the LOGITS -> PROBS -> INDICES dataflow and applies the same
five fusions as JAX's, each onto one call of the port's sampler surface
(``ops/sampling.py``), so on CUDA rows onto one launch of the sampler kernel
``csrc/sampling.cu``:

  Softmax -> Sample                 sampling_from_logits
  TopK -> TopP -> Sample (probs)    top_k_top_p_sampling_from_probs
  TopK -> Sample (probs)            top_k_sampling_from_probs
  TopP -> Sample (probs)            top_p_sampling_from_probs
  MinP -> Sample (probs)            min_p_sampling_from_probs

A processor left alone runs as JAX's does: TopK on logits is
``top_k_mask_logits`` and on probabilities ``top_k_renorm_probs``, TopP is
``top_p_renorm_probs`` (each a sampler launch); Temperature, Softmax and
MinP are plain PyTorch, as they are plain jnp in JAX.

Randomness comes as ``seed=`` (an int, or a one-element int32 tensor on the
rows' device) or ``generator=`` (a ``torch.Generator`` that draws one), as in
the port's sampler functions, in place of JAX's ``key=``. The same seed
draws the same tokens as the direct sampler call. A pipe whose dataflow does
not type-check raises ``TypeError`` (JAX's asserts).
"""

from __future__ import annotations

import dataclasses
import enum
import numbers
from typing import Callable, List, Sequence

import torch

from flashinfer_tpu_torch.ops import sampling as S

__all__ = [
    "TensorType",
    "TaggedTensor",
    "LogitsProcessor",
    "Temperature",
    "Softmax",
    "TopK",
    "TopP",
    "MinP",
    "Sample",
    "LogitsPipe",
    "compile_pipeline",
]


class TensorType(enum.Enum):
    LOGITS = "logits"
    PROBS = "probs"
    INDICES = "indices"


@dataclasses.dataclass
class TaggedTensor:
    """A tensor tagged with its pipeline type."""

    data: torch.Tensor
    type: TensorType

    @staticmethod
    def logits(x):
        return TaggedTensor(x, TensorType.LOGITS)

    @staticmethod
    def probs(x):
        return TaggedTensor(x, TensorType.PROBS)


class LogitsProcessor:
    """A processor; its parameters come at construction or with each call
    (keyword arguments of the pipe, which win)."""

    IN: TensorType
    OUT: TensorType
    param_names: Sequence[str] = ()

    def __init__(self, **params):
        self.params = params

    def _get(self, name, runtime):
        if name in runtime:
            return runtime[name]
        if name in self.params:
            return self.params[name]
        raise KeyError(f"{type(self).__name__} needs parameter {name!r}")

    def apply(self, x: torch.Tensor, runtime: dict) -> torch.Tensor:
        raise NotImplementedError


def _per_row(v, x: torch.Tensor):
    """A Python number as it is (no copy to the device), or a [B] parameter
    as a tensor that broadcasts over rows."""
    if isinstance(v, numbers.Number):
        return float(v)
    t = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    return t[:, None] if t.ndim else t


class Temperature(LogitsProcessor):
    IN = OUT = TensorType.LOGITS
    param_names = ("temperature",)

    def apply(self, x, runtime):
        """The f32 quotient, as JAX's (bf16 logits promote to f32); rows at
        temperature <= 0 are divided by 1. A scalar stays a host number."""
        t = _per_row(self._get("temperature", runtime), x)
        if isinstance(t, float):
            return x.float() / (t if t > 0 else 1.0)
        return x.float() / torch.where(t > 0, t, 1.0)


class Softmax(LogitsProcessor):
    IN = TensorType.LOGITS
    OUT = TensorType.PROBS

    def apply(self, x, runtime):
        # a temperature is its own Temperature processor upstream
        return S.softmax(x, 1.0)


class TopK(LogitsProcessor):
    """On logits: the rest masked to -inf. On probabilities: the top k
    renormalised."""

    IN = OUT = None  # either; resolved when the pipe compiles
    param_names = ("top_k",)

    def apply_logits(self, x, runtime):
        return S.top_k_mask_logits(x, self._get("top_k", runtime))

    def apply_probs(self, x, runtime):
        return S.top_k_renorm_probs(x, self._get("top_k", runtime))


class TopP(LogitsProcessor):
    IN = OUT = TensorType.PROBS
    param_names = ("top_p",)

    def apply(self, x, runtime):
        return S.top_p_renorm_probs(x, self._get("top_p", runtime))


class MinP(LogitsProcessor):
    IN = OUT = TensorType.PROBS
    param_names = ("min_p",)

    def apply(self, x, runtime):
        t = _per_row(self._get("min_p", runtime), x) * x.amax(
            dim=-1, keepdim=True)
        masked = torch.where(x >= t, x, 0.0)
        return masked / masked.sum(dim=-1, keepdim=True)


def _rand(runtime: dict) -> dict:
    """The pipe's randomness as the sampler functions take it."""
    return dict(seed=runtime.get("seed"), generator=runtime.get("generator"))


class Sample(LogitsProcessor):
    IN = None  # LOGITS or PROBS
    OUT = TensorType.INDICES
    param_names = ("seed", "generator")

    def __init__(self, deterministic: bool = True, **params):
        super().__init__(**params)
        self.deterministic = deterministic

    def _rand(self, runtime):
        return _rand({**self.params, **runtime})

    def apply_probs(self, x, runtime):
        return S.sampling_from_probs(x, **self._rand(runtime))

    def apply_logits(self, x, runtime):
        return S.sampling_from_logits(x, **self._rand(runtime))


@dataclasses.dataclass
class _Step:
    fn: Callable[[torch.Tensor, dict], torch.Tensor]
    out_type: TensorType
    name: str


def _need(cur: TensorType, want: TensorType, what: str) -> None:
    if cur != want:
        raise TypeError(f"{what} needs {want.name}, the pipe has {cur.name}")


def compile_pipeline(
    processors: Sequence[LogitsProcessor],
    initial: TensorType = TensorType.LOGITS,
) -> List[_Step]:
    """Legalise and fuse (flashinfer_tpu/logits_processor/__init__.py:179):
    the fusions the module docstring lists, then one step a processor."""
    steps: List[_Step] = []
    cur = initial
    i = 0
    procs = list(processors)
    while i < len(procs):
        p = procs[i]
        nxt = procs[i + 1] if i + 1 < len(procs) else None
        nxt2 = procs[i + 2] if i + 2 < len(procs) else None
        probs = cur == TensorType.PROBS

        fused = None
        if isinstance(p, Softmax) and isinstance(nxt, Sample):
            _need(cur, TensorType.LOGITS, "Softmax")
            fused = (2, "fused_softmax_sample",
                     lambda x, r, _s=nxt: _s.apply_logits(x, r))
        elif (isinstance(p, TopK) and isinstance(nxt, TopP)
              and isinstance(nxt2, Sample) and probs):
            def fn(x, r, _k=p, _p=nxt, _s=nxt2):
                return S.top_k_top_p_sampling_from_probs(
                    x, _k._get("top_k", r), _p._get("top_p", r),
                    **_s._rand(r))
            fused = (3, "fused_topk_topp_sample", fn)
        elif isinstance(p, TopK) and isinstance(nxt, Sample) and probs:
            fused = (2, "fused_topk_sample",
                     lambda x, r, _k=p, _s=nxt: S.top_k_sampling_from_probs(
                         x, _k._get("top_k", r), **_s._rand(r)))
        elif isinstance(p, TopP) and isinstance(nxt, Sample) and probs:
            fused = (2, "fused_topp_sample",
                     lambda x, r, _p=p, _s=nxt: S.top_p_sampling_from_probs(
                         x, _p._get("top_p", r), **_s._rand(r)))
        elif isinstance(p, MinP) and isinstance(nxt, Sample) and probs:
            fused = (2, "fused_minp_sample",
                     lambda x, r, _p=p, _s=nxt: S.min_p_sampling_from_probs(
                         x, _p._get("min_p", r), **_s._rand(r)))
        if fused is not None:
            n, name, fn = fused
            steps.append(_Step(fn, TensorType.INDICES, name))
            cur = TensorType.INDICES
            i += n
            continue

        # one processor alone
        if isinstance(p, Temperature):
            _need(cur, TensorType.LOGITS, "Temperature")
            steps.append(_Step(p.apply, TensorType.LOGITS, "temperature"))
        elif isinstance(p, Softmax):
            _need(cur, TensorType.LOGITS, "Softmax")
            steps.append(_Step(
                lambda x, r: torch.softmax(x.float(), dim=-1),
                TensorType.PROBS, "softmax"))
            cur = TensorType.PROBS
        elif isinstance(p, TopK):
            if cur == TensorType.LOGITS:
                steps.append(_Step(p.apply_logits, TensorType.LOGITS,
                                   "topk_mask_logits"))
            else:
                steps.append(_Step(p.apply_probs, TensorType.PROBS,
                                   "topk_renorm"))
        elif isinstance(p, (TopP, MinP)):
            _need(cur, TensorType.PROBS, type(p).__name__)
            steps.append(_Step(p.apply, TensorType.PROBS, type(p).__name__))
        elif isinstance(p, Sample):
            if cur == TensorType.LOGITS:
                steps.append(_Step(p.apply_logits, TensorType.INDICES,
                                   "sample_logits"))
            else:
                steps.append(_Step(p.apply_probs, TensorType.INDICES,
                                   "sample_probs"))
            cur = TensorType.INDICES
        else:
            raise TypeError(f"unknown processor {type(p).__name__}")
        i += 1
    return steps


class LogitsPipe:
    """A compiled processor list (the reference's pipeline.py:33).

    >>> pipe = LogitsPipe([Temperature(), Softmax(), TopP(), Sample()])
    >>> ids = pipe(logits, temperature=0.8, top_p=0.9, seed=0)
    """

    def __init__(
        self,
        processors: Sequence[LogitsProcessor],
        compile: bool = True,
        input_type: TensorType = TensorType.LOGITS,
    ):
        self.processors = list(processors)
        self._input_type = input_type
        self.steps = compile_pipeline(self.processors, input_type)

    @property
    def compiled_names(self) -> List[str]:
        return [s.name for s in self.steps]

    def __call__(self, x, **runtime):
        if isinstance(x, TaggedTensor):
            _need(x.type, self._input_type, "this pipe's input")
            x = x.data
        for step in self.steps:
            x = step.fn(x, runtime)
        return x
