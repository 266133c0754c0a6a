"""RMSNorm, plain or with the residual add fused in: a CUDA kernel on the
card, its plain version on the CPU.

Replaces the TPU kernel ``_rmsnorm_kernel`` (flashinfer_tpu/ops/norm.py:80,
launched by ``rmsnorm_pallas``) and carries the JAX package's
``fused_add_rmsnorm`` and the Gemma forms (:51-77), which it leaves to XLA's
fusion. The kernel is ``csrc/norm.cu`` (its note says what bounds it and how
the design answers): one launch computes the plain norm, or writes
``new_residual = round(x + residual)`` and normalises the rounded sum, as
JAX does, so the fused form gives the same bits as an add followed by the
plain norm. The serving steps take the fused form at every norm after the
first, which spares one launch and one round trip of the residual stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch import jit

__all__ = [
    "rmsnorm",
    "rmsnorm_plain",
    "fused_add_rmsnorm",
    "fused_add_rmsnorm_plain",
    "gemma_rmsnorm",
    "gemma_fused_add_rmsnorm",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rmsnorm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
    weight_bias: float = 0.0,
) -> torch.Tensor:
    """out = x * rsqrt(mean(x^2) + eps) * (weight + weight_bias), f32 math,
    cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    w = weight.float() + weight_bias
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def fused_add_rmsnorm_plain(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-6, *, weight_bias: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmsnorm_plain(new_residual), new_residual), new_residual = x +
    residual summed in f32 and rounded to x's dtype."""
    new_residual = (x.float() + residual.float()).to(x.dtype)
    return (rmsnorm_plain(new_residual, weight, eps, weight_bias=weight_bias),
            new_residual)


def _lib():
    fn = jit.load("norm").fi_rmsnorm
    if fn.argtypes is None:
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        fn.argtypes = [P, P, P, P, P, I, I, L, L, L, L, I, F, F, I, P]
        fn.restype = I
    return fn


def _rows(t: torch.Tensor, hidden: int) -> torch.Tensor:
    """t as [rows, hidden] with a unit column stride (a view where it can)."""
    t2 = t.reshape(-1, hidden)
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _launch(x, residual, weight, eps, weight_bias, empty=False):
    """One launch on CUDA tensors: (out, new_residual or None). ``empty``
    launches the kernel's empty counterpart of the same layout (the launch
    floor, for timing; not counted)."""
    hidden = x.shape[-1]
    if weight.shape != (hidden,) or not weight.is_cuda:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} "
                         f"does not match hidden {hidden} on the card")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes bf16/f16/f32, got {x.dtype}")
    mixed = [t.dtype for t in (weight, residual)
             if t is not None and t.dtype != x.dtype]
    if mixed:
        raise TypeError(f"rmsnorm kernel takes one dtype, got x {x.dtype} "
                        f"with {mixed}")
    if residual is not None and (residual.shape != x.shape
                                 or not residual.is_cuda):
        raise ValueError(f"residual {tuple(residual.shape)} on "
                         f"{residual.device} does not match x "
                         f"{tuple(x.shape)} on the card")
    # the kernel reads w as a dense array; a strided weight is copied (and
    # the kernel waits for that copy before it reads w)
    weight = weight.contiguous()
    x2 = _rows(x, hidden)
    r2 = None if residual is None else _rows(residual, hidden)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    r_out = None if residual is None else torch.empty_like(out)
    if x2.shape[0]:
        err = _lib()(
            x2.data_ptr(), None if r2 is None else r2.data_ptr(),
            weight.data_ptr(), out.data_ptr(),
            None if r_out is None else r_out.data_ptr(), x2.shape[0], hidden,
            x2.stride(0), 0 if r2 is None else r2.stride(0), out.stride(0),
            out.stride(0), _DTYPES[x.dtype], eps, weight_bias, int(empty),
            torch.cuda.current_stream(x.device).cuda_stream)
        jit.check(err, "rmsnorm kernel (hidden at most 32768 16-bit or 16384 "
                  "f32 values 16-byte aligned, 8192 otherwise)")
        if not empty:
            rmsnorm.launches += 1
    return (out.reshape(x.shape),
            None if r_out is None else r_out.reshape(x.shape))


def rmsnorm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
    weight_bias: float = 0.0,
) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., hidden]; weight: [hidden].

    A CUDA tensor launches the kernel (counted in ``rmsnorm.launches``, as
    is every fused launch); a CPU tensor takes the plain version. On the
    card x, weight (and a fused residual) must share one dtype of bf16,
    f16 or f32 (a weight of another dtype raises, it is not converted), and
    hidden is at most 32768 bf16/f16 or 16384 f32 values where hidden and
    every row stride are multiples of 16 bytes, 8192 otherwise (wider rows
    raise)."""
    if not x.is_cuda:
        return rmsnorm_plain(x, weight, eps, weight_bias=weight_bias)
    return _launch(x, None, weight, eps, weight_bias)[0]


rmsnorm.launches = 0


def fused_add_rmsnorm(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-6, *, weight_bias: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """new_residual = x + residual (f32 sum, rounded to x's dtype); returns
    (rmsnorm(new_residual), new_residual), JAX's signature and order.

    One launch on CUDA tensors (x, residual and weight of one dtype, mixed
    dtypes raise; hidden within ``rmsnorm``'s limits), counted in
    ``rmsnorm.launches``; new_residual is a new tensor, the inputs are not
    written. A CPU tensor takes the plain version."""
    if not x.is_cuda:
        return fused_add_rmsnorm_plain(x, residual, weight, eps,
                                       weight_bias=weight_bias)
    return _launch(x, residual, weight, eps, weight_bias)


def gemma_rmsnorm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Gemma's convention: scale by (1 + weight)."""
    return rmsnorm(x, weight, eps, weight_bias=1.0)


def gemma_fused_add_rmsnorm(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_add_rmsnorm`` with Gemma's (1 + weight)."""
    return fused_add_rmsnorm(x, residual, weight, eps, weight_bias=1.0)


def rmsnorm_empty(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Launch the kernel's empty counterpart (nothing but the dependency
    wait) with the grid, block and launch path ``rmsnorm(x, weight)``
    takes: the launch floor, for timing. Not counted in
    ``rmsnorm.launches``."""
    _launch(x, None, weight, 1e-6, 0.0, empty=True)


def add_rmsnorm(addend: Optional[torch.Tensor], residual: torch.Tensor,
                weight: torch.Tensor, eps: float) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(normed, residual stream) for a norm that first adds a sublayer's
    output: ``fused_add_rmsnorm(addend, residual, ...)``, or the plain norm
    of ``residual`` when there is nothing to add (``addend`` None)."""
    if addend is None:
        return rmsnorm(residual, weight, eps), residual
    return fused_add_rmsnorm(addend, residual, weight, eps)
