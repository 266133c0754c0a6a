"""Benchmark timers and analytic FLOP / byte calculators.

Counterpart of ``flashinfer_tpu/testing/utils.py`` (the reference's
``flashinfer/testing/utils.py``):

* ``attention_flops``, ``attention_tflops_per_sec``, ``attention_bytes``,
  ``attention_tb_per_sec`` and ``gemm_flops`` give the JAX package's
  numbers exactly;
* ``bench_gpu_time`` (JAX's ``bench_tpu_time``) times whole calls with CUDA
  events; ``bench_gpu_time_differential`` (JAX's
  ``bench_tpu_time_differential``) captures n_short and n_long chained
  steps in two CUDA graphs and returns (T(long) - T(short)) / (long -
  short) over their replays, which cancels the launch and the replay's
  fixed cost. On CPU tensors (no card) both time with ``perf_counter``;
* ``assert_close_with_mismatch_tolerance`` and ``quantize_fp8_rowwise_ref``.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "attention_flops",
    "attention_tflops_per_sec",
    "attention_bytes",
    "attention_tb_per_sec",
    "gemm_flops",
    "bench_gpu_time",
    "bench_gpu_time_differential",
    "assert_close_with_mismatch_tolerance",
    "quantize_fp8_rowwise_ref",
]


# ------------------------------------------------------------ calculators

def attention_flops(
    batch_size: int,
    qo_len: int,
    kv_len: int,
    head_dim_qk: int,
    head_dim_vo: int,
    num_qo_heads: int,
    causal: bool = False,
) -> float:
    """Attention FLOPs (two matmuls; causal counts the visible area)."""
    if causal:
        # query row i sees kv_len - qo_len + i + 1 keys
        area = qo_len * (kv_len - qo_len) + qo_len * (qo_len + 1) / 2
    else:
        area = qo_len * kv_len
    per_head = 2 * area * head_dim_qk + 2 * area * head_dim_vo
    return batch_size * num_qo_heads * per_head


def attention_tflops_per_sec(seconds: float, **kw) -> float:
    return attention_flops(**kw) / seconds / 1e12


def attention_bytes(
    batch_size: int,
    qo_len: int,
    kv_len: int,
    head_dim_qk: int,
    head_dim_vo: int,
    num_qo_heads: int,
    num_kv_heads: int,
    q_itemsize: int = 2,
    kv_itemsize: int = 2,
    o_itemsize: int = 2,
) -> float:
    """The least device-memory traffic: q and kv read once, o written once."""
    q = batch_size * qo_len * num_qo_heads * head_dim_qk * q_itemsize
    kv = (batch_size * kv_len * num_kv_heads * (head_dim_qk + head_dim_vo)
          * kv_itemsize)
    o = batch_size * qo_len * num_qo_heads * head_dim_vo * o_itemsize
    return q + kv + o


def attention_tb_per_sec(seconds: float, **kw) -> float:
    """TB/s achieved against ``attention_bytes``."""
    return attention_bytes(**kw) / seconds / 1e12


def gemm_flops(m: int, n: int, k: int, batch: int = 1) -> float:
    return 2.0 * batch * m * n * k


# ------------------------------------------------------------------ timers

def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def bench_gpu_time(
    fn: Callable,
    *args,
    warmup: int = 3,
    repeats: int = 10,
    reducer: str = "median",
    device=None,
) -> float:
    """Seconds a call of ``fn(*args)`` takes: CUDA events around each call
    on the card (the device of the first tensor argument, or ``device``),
    ``perf_counter`` around each call on the CPU. JAX's ``bench_tpu_time``."""
    device = torch.device(device) if device is not None else _device_of(args)
    for _ in range(warmup):
        fn(*args)
    times = []
    if _on_card(device):
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(getattr(np, reducer)(times))


def bench_gpu_time_differential(
    step: Callable,
    carry0,
    *invariants,
    n_short: int = 4,
    n_long: int = 20,
    repeats: int = 5,
) -> float:
    """Seconds a step of ``step`` takes on the device, as (T(n_long) -
    T(n_short)) / (n_long - n_short): each count of chained steps is
    captured in one CUDA graph and its replays timed with CUDA events (the
    least of ``repeats``), so launch gaps and the replay's fixed cost
    cancel. JAX's ``bench_tpu_time_differential``.

    ``step(carry, *invariants) -> carry`` chains a data dependency through
    ``carry`` so the steps run in order. On the CPU the same difference is
    taken over eager loops timed with ``perf_counter``."""
    device = _device_of((carry0,) + invariants)
    on_card = _on_card(device)

    def chain(n):
        c = carry0
        for _ in range(n):
            c = step(c, *invariants)
        return c

    def timed(n) -> float:
        if not on_card:
            chain(n)  # warm-up
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                chain(n)
                best = min(best, time.perf_counter() - t0)
            return best
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):  # warm-up outside the capture
            chain(n)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain(n)
        graph.replay()
        torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        del graph
        return best

    t_short = timed(n_short)
    t_long = timed(n_long)
    return max((t_long - t_short) / (n_long - n_short), 1e-9)


# ----------------------------------------------------------- comparisons

def assert_close_with_mismatch_tolerance(
    actual,
    desired,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    max_mismatched_elements: int = 0,
):
    """allclose that lets at most ``max_mismatched_elements`` elements
    differ (for kernels whose ties or roundings may fall the other way).
    Takes tensors (any device) or arrays."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float64).numpy()
        return np.asarray(x, np.float64)

    actual, desired = f64(actual), f64(desired)
    bad = ~np.isclose(actual, desired, rtol=rtol, atol=atol, equal_nan=True)
    n_bad = int(bad.sum())
    if n_bad > max_mismatched_elements:
        idx = np.argwhere(bad)[:10]
        raise AssertionError(
            f"{n_bad} mismatched elements (> {max_mismatched_elements} "
            f"allowed) at rtol={rtol}, atol={atol}; first bad indices: "
            f"{idx.tolist()}; actual={actual[bad][:10]}, "
            f"desired={desired[bad][:10]}")


def quantize_fp8_rowwise_ref(x):
    """Row-wise e4m3 quantization oracle: scale = amax / 448 a row (1 for a
    zero row), values ``x / scale`` rounded to nearest even. Returns
    (values float8_e4m3fn, scales f32 [..., 1]) as CPU tensors; the
    arithmetic runs in ``x``'s dtype, as JAX's NumPy oracle's does."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).cpu()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn), scale.to(torch.float32)
