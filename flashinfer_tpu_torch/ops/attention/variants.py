"""Attention variants: the JAX package's hook set
(``flashinfer_tpu/ops/attention/variants.py``) in PyTorch.

A variant is a bundle of optional hooks applied to plain tensors:

  query_transform(params, q) -> q                         before Q.K^T
  logits_transform(params, logits, q_pos, kv_pos, head_idx) -> logits
  logits_mask(params, q_pos, kv_pos, head_idx) -> bool     True = keep
  sink_logits(params) -> [num_heads]                       extra softmax logit
  output_transform(params, out) -> out                     after P.V

``q_pos``, ``kv_pos`` and ``head_idx`` are broadcastable integer tensors
(absolute query position, key position, query head). ``use_softmax`` False
makes the transformed logits the weights themselves (lse is 0).

The CUDA kernels cannot call Python hooks. Each built-in variant carries a
``KernelVariant``: the few numbers the flash and paged kernels read (soft
cap, ALiBi on or off, sigmoid scale and bias), on the libraries built once
for every variant. A variant with hooks of the caller's own goes through
the variant JIT (``flashinfer_tpu_torch/jit/variant.py``): on a CUDA
tensor its hooks are traced into scalar CUDA functions, spliced into the
flash or paged kernel and built by nvcc at first use (cached on disk,
keyed by a hash); ``VARIANT_JIT`` says what the trace takes. The paged
kernel applies no output transform and needs softmax, as the TPU kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from flashinfer_tpu_torch.utils import apply_logits_soft_cap

__all__ = [
    "AttentionVariant",
    "DefaultAttention",
    "FlashSigmoid",
    "KernelVariant",
    "make_default_variant",
]

Params = Any  # per-call tensors the hooks read (slopes, sinks, scales, ...)

VARIANT_JIT = (
    "the variant JIT compiles hooks of elementwise scalar math into the "
    "flash and paged kernels: + - * / // % ** by constants or traced values, "
    "negation, abs, comparisons, & | ~, torch.where, minimum / maximum / "
    "clamp, exp, exp2, log, log2, tanh, sigmoid, reciprocal, sqrt, rsqrt, "
    "sin, cos, .float() / .int() / .bool(), Python numbers, and leaves of "
    "variant_params that are numbers, one-element f32/int32 tensors, or 1-D "
    "f32/int32 tables indexed by an int expression (p[name][:, None] reads "
    "the row's head in the flash kernel's query and output transforms)")


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """What the flash and paged kernels read of a built-in variant, on
    their libraries built without a variant header. ALiBi slopes come from
    ``variant_params["alibi_slopes"]``; ``sigmoid`` is (scale, bias) of
    ``FlashSigmoid`` (weights, no softmax; flash only). A variant without
    one, or with a query transform, logit mask or (flash) output transform
    of its own, runs through the variant JIT instead."""

    logits_soft_cap: float = 0.0
    use_alibi: bool = False
    sigmoid: Optional[Tuple[float, float]] = None


@dataclasses.dataclass(frozen=True)
class AttentionVariant:
    """Hooks applied by the plain versions and, traced, by the kernels'
    builds for the variant; ``kernel`` is set for the built-in variants the
    kernels' own libraries run."""

    name: str = "default"
    query_transform: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
    logits_transform: Optional[Callable[..., torch.Tensor]] = None
    logits_mask: Optional[Callable[..., torch.Tensor]] = None
    sink_logits: Optional[Callable[[Params], torch.Tensor]] = None
    output_transform: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
    use_softmax: bool = True
    kernel: Optional[KernelVariant] = None


def _alibi_bias(slopes, q_pos, kv_pos, head_idx):
    return slopes[head_idx] * (kv_pos - q_pos).float()


def make_default_variant(
    *,
    logits_soft_cap: float = 0.0,
    use_alibi: bool = False,
    has_sink: bool = False,
) -> AttentionVariant:
    """The reference's ``DefaultAttention<soft_cap, alibi>`` as hooks: ALiBi
    ``slope[h] * (kv_pos - q_pos)`` is added first, then the soft cap.
    Windows and custom masks are kernel arguments, not hooks. With
    ``has_sink`` the sink logits come from ``params["sink"]``."""

    def logits_transform(params, logits, q_pos, kv_pos, head_idx):
        if use_alibi:
            logits = logits + _alibi_bias(params["alibi_slopes"], q_pos,
                                          kv_pos, head_idx)
        return apply_logits_soft_cap(logits, logits_soft_cap)

    transform = logits_transform if (use_alibi or logits_soft_cap > 0.0) \
        else None
    sink = (lambda params: params["sink"]) if has_sink else None
    return AttentionVariant(
        name=f"default(cap={logits_soft_cap},alibi={use_alibi},"
             f"sink={has_sink})",
        logits_transform=transform, sink_logits=sink,
        kernel=KernelVariant(logits_soft_cap=float(logits_soft_cap),
                             use_alibi=use_alibi))


DefaultAttention = make_default_variant()


def FlashSigmoid(scale: float = 1.0, bias: float = 0.0) -> AttentionVariant:
    """Sigmoid attention: weights ``1 / (1 + exp(-(logits * scale +
    bias)))``, no softmax normalisation."""

    def logits_transform(params, logits, q_pos, kv_pos, head_idx):
        return torch.reciprocal(1.0 + torch.exp(-(logits * scale + bias)))

    return AttentionVariant(
        name="flash_sigmoid", logits_transform=logits_transform,
        use_softmax=False,
        kernel=KernelVariant(sigmoid=(float(scale), float(bias))))
