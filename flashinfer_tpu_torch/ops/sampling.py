"""Sorting-free sampling: temperature softmax and the fused sampler family.

Counterpart of ``flashinfer_tpu/ops/sampling.py``. ``family_call`` is the
counterpart of ``_family_call`` (:597) with the int32 seed passed directly:
on a CUDA tensor it launches the kernel ``csrc/sampling.cu`` (which replaces
the TPU kernel ``_family_kernel``, sampling.py:484), on a CPU tensor it runs
``family_plain``. Both follow the TPU kernel step for step (32-step pivot
bisections, renorm between top-k and top-p, a Gumbel-max draw whose noise is
a murmur3 finalizer of (seed, row, lane) on the seed's 32 bits), so the same
int32 seed draws the same tokens as the JAX package.

The kernel has two routes, which its C entry chooses from the vocabulary
(``sampler_route`` reports the choice): a row held in the shared memory of
a cluster of CTAs where the row's slices fit, else one CTA a row streaming
it from L2 on every step.

Filters: ``none``, ``top_k``, ``top_p``, ``min_p``, ``top_k_top_p_joint`` and
``top_k_top_p_seq`` (top-k, renormalise, top-p: the engine's order). Output
modes: ``sample`` (tokens [B] int32), ``renorm`` (kept probabilities
renormalised, [B, V] f32) and ``mask_logits`` (logits outside the top-k set
set to -inf).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from flashinfer_tpu_torch import jit

__all__ = [
    "softmax",
    "family_call",
    "family_plain",
    "pivot_search_plain",
    "sampler_route",
    "sampler_stats",
    "top_k_top_p_sampling_from_probs",
    "draw_seed",
]

BISECT_ITERS = 32
_FILTS = {"none": 0, "top_k": 1, "top_p": 2, "min_p": 3,
          "top_k_top_p_joint": 4, "top_k_top_p_seq": 5}
_OUTS = {"sample": 0, "renorm": 1, "mask_logits": 2}
_MASK32 = 0xFFFFFFFF


def _row_param(x, batch: int, dtype, device) -> torch.Tensor:
    """Scalar, [B] or [B, 1] -> [B, 1]."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.ndim == 0:
        t = t.expand(batch)
    return t.reshape(batch, 1)


def softmax(logits: torch.Tensor,
            temperature: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """Temperature softmax in f32; rows with temperature 0 give a one-hot of
    the argmax (split evenly over ties)."""
    x = logits.float()
    t = _row_param(temperature, x.shape[0], torch.float32, x.device)
    safe_t = torch.where(t > 0, t, 1.0)
    y = torch.softmax(x / safe_t, dim=-1)
    greedy = (x == x.amax(dim=-1, keepdim=True)).float()
    greedy = greedy / greedy.sum(dim=-1, keepdim=True)
    return torch.where(t > 0, y, greedy)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed in [0, 2**31 - 1) from a (CPU) generator."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def _bisect(vals, ok_fn, lo, hi):
    for _ in range(BISECT_ITERS):
        mid = (lo + hi) * 0.5
        ok = ok_fn(vals, mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def pivot_search_plain(vals, ok_fn, lo, hi, levels: int):
    """``_bisect``'s 32 steps taken ``levels`` at a time, as the cluster
    kernel takes them: each sweep evaluates ``ok_fn`` at the 2**levels - 1
    midpoints the next ``levels`` steps could visit (each ``(lo + hi) *
    0.5`` from its own path's lo and hi; node n's children are 2n, not ok,
    and 2n + 1, ok), then walks the decisions. Gives ``_bisect``'s pivots
    bit for bit. lo, hi [B, 1]."""
    done = 0
    while done < BISECT_ITERS:
        nl, nh, mids, oks = [lo], [hi], [], []
        for n in range(1, 2 ** levels):
            if n > 1:
                par = n // 2 - 1
                nl.append(mids[par] if n & 1 else nl[par])
                nh.append(nh[par] if n & 1 else mids[par])
            mids.append((nl[n - 1] + nh[n - 1]) * 0.5)
            oks.append(ok_fn(vals, mids[-1]))
        mids, oks = torch.cat(mids, -1), torch.cat(oks, -1)
        node = torch.zeros_like(lo, dtype=torch.int64)  # 0-based: n - 1
        for _ in range(min(levels, BISECT_ITERS - done)):
            mid, ok = mids.gather(-1, node), oks.gather(-1, node)
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
            node = 2 * node + 1 + ok.long()
        done += levels
    return lo


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for 0 <= h < 2**32 in int64 without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + ((h * hi) & 0xFFFF) * 65536) & _MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seed: int, batch: int, vocab: int,
                 device=None) -> torch.Tensor:
    """The kernels' Gumbel noise [batch, vocab]: murmur3 finalizer (twice)
    of seed + row * 0x9E3779B9 + lane * 40503 in uint32 arithmetic (int64
    masked to 32 bits here), top 24 bits as a uniform."""
    row = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(vocab, dtype=torch.int64, device=device)[None, :]
    h = (int(seed) + _mul32(row, 0x9E3779B9) + lane * 40503) & _MASK32
    u24 = _mix(_mix(h)) >> 8
    u = u24.float() * (1.0 / (1 << 24)) + 1e-7
    return -torch.log(-torch.log(u))


def family_plain(x: torch.Tensor, seed: int, k: torch.Tensor,
                 p: torch.Tensor, *, filt: str, out_mode: str) -> torch.Tensor:
    """The sampler family in plain PyTorch (the kernel's arithmetic, all
    rows at once). x [B, V] f32; k [B, 1] int32; p [B, 1] f32."""
    x = x.float()
    batch, vocab = x.shape
    zeros = torch.zeros(batch, 1, device=x.device)

    def count_ok(v, mid):
        return (v > mid).sum(dim=-1, keepdim=True) >= k

    def mass_ok(v, mid):
        return torch.where(v > mid, v, 0.0).sum(dim=-1, keepdim=True) >= p

    def topk_pivot(v):
        t = _bisect(v, count_ok, zeros, v.amax(dim=-1, keepdim=True))
        return torch.where(k >= vocab, -1.0, t)

    def topp_pivot(v):
        t = _bisect(v, mass_ok, zeros, v.amax(dim=-1, keepdim=True))
        return torch.where(p >= 1.0, -1.0, t)

    if out_mode == "mask_logits":
        t = _bisect(x, count_ok, x.amin(dim=-1, keepdim=True),
                    x.amax(dim=-1, keepdim=True))
        t = torch.where(k >= vocab, t - 1.0, t)
        return torch.where(x > t, x, float("-inf"))

    if filt == "none":
        masked = x
    elif filt == "top_k":
        masked = torch.where(x > topk_pivot(x), x, 0.0)
    elif filt == "top_p":
        masked = torch.where(x > topp_pivot(x), x, 0.0)
    elif filt == "min_p":
        masked = torch.where(x >= p * x.amax(dim=-1, keepdim=True), x, 0.0)
    elif filt == "top_k_top_p_joint":
        t = torch.maximum(topk_pivot(x), topp_pivot(x))
        masked = torch.where(x > t, x, 0.0)
    elif filt == "top_k_top_p_seq":
        p1 = torch.where(x > topk_pivot(x), x, 0.0)
        p1 = p1 / p1.sum(dim=-1, keepdim=True)
        masked = torch.where(p1 > topp_pivot(p1), p1, 0.0)
    else:
        raise ValueError(f"unknown filter {filt!r}")

    if out_mode == "renorm":
        return masked / masked.sum(dim=-1, keepdim=True)
    if out_mode != "sample":
        raise ValueError(f"unknown out_mode {out_mode!r}")
    g = gumbel_noise(seed, batch, vocab, x.device)
    scored = torch.where(masked > 0, torch.log(masked) + g, float("-inf"))
    return scored.argmax(dim=-1).to(torch.int32)


def _seed32(seed) -> int:
    """A seed in [-2**31, 2**32) as the int32 of its low 32 bits."""
    s = int(seed)
    if not -2**31 <= s < 2**32:
        raise ValueError(f"seed {s} is outside [-2**31, 2**32)")
    s &= _MASK32
    return s - 2**32 if s >= 2**31 else s


def _lib():
    fn = jit.load("sampling").fi_sampling_family
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, P, I, P, P, P, P]
        fn.restype = I
    return fn


def sampler_route(vocab: int) -> dict:
    """The route the kernel takes for rows of ``vocab`` entries, as its C
    entry chooses it (needs the card): ``cluster`` (the row in the shared
    memory of ``cluster`` CTAs, ``levels`` bisection steps a cluster pass,
    ``max_active_clusters`` clusters on the card at once) where the row's
    slices fit, else ``stream`` (cluster 0)."""
    fn = jit.load("sampling").fi_sampling_route
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 5)()
    jit.check(fn(vocab, info), "sampler route query")
    cluster, levels, threads, slice_, clusters = info
    return dict(route="cluster" if cluster else "stream", cluster=cluster,
                levels=levels, threads=threads, slice=slice_,
                max_active_clusters=clusters)


def _launch(x, seed, k, p, filt, out_mode, stats=None):
    """One launch of the kernel on CUDA rows (counted in
    ``family_call.launches``), or ``family_plain`` on CPU rows; ``stats``
    [B, 3] int32 takes the cluster route's pass counts."""
    if filt not in _FILTS or out_mode not in _OUTS:
        raise ValueError(f"unknown filter {filt!r} or out_mode {out_mode!r}")
    batch, vocab = x.shape
    k = _row_param(k, batch, torch.int32, x.device)
    p = _row_param(p, batch, torch.float32, x.device)
    seed_dev = x.is_cuda and isinstance(seed, torch.Tensor) and seed.is_cuda
    if seed_dev:
        if (seed.dtype != torch.int32 or seed.numel() != 1
                or seed.device != x.device):
            raise TypeError("a tensor seed is one int32 on the rows' device")
    else:
        seed = _seed32(seed)
    if not x.is_cuda:
        return family_plain(x, seed, k, p, filt=filt, out_mode=out_mode)
    if x.dtype != torch.float32:
        raise TypeError(f"sampler kernel takes f32 rows, got {x.dtype}")
    x = x.contiguous()
    k, p = k.contiguous(), p.contiguous()
    tok = torch.empty(batch, dtype=torch.int32, device=x.device)
    row = (torch.empty_like(x) if out_mode != "sample"
           else torch.empty(0, device=x.device))
    err = _lib()(x.data_ptr(), k.data_ptr(), p.data_ptr(), batch, vocab,
                 _FILTS[filt], _OUTS[out_mode],
                 seed.data_ptr() if seed_dev else None,
                 0 if seed_dev else seed, tok.data_ptr(), row.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    jit.check(err, "sampler kernel")
    family_call.launches += 1
    return tok if out_mode == "sample" else row


def family_call(x: torch.Tensor, seed, k, p, *, filt: str,
                out_mode: str) -> torch.Tensor:
    """The sampler family. x [B, V] (probabilities, or logits for
    ``mask_logits``); k top-k per row (scalar, [B] or [B, 1]); p top-p or
    min-p per row; seed the Gumbel noise's seed: an int in [-2**31, 2**32)
    (its low 32 bits, passed by value), or an int32 tensor of one element on
    x's device, which the kernel reads when it runs (so a CUDA graph can
    replay with a new seed).

    A CUDA tensor launches the kernel on the route ``sampler_route`` names
    (or raises); a CPU tensor takes ``family_plain``."""
    return _launch(x, seed, k, p, filt, out_mode)


family_call.launches = 0


def sampler_stats(x: torch.Tensor, k, p, *, filt: str,
                  out_mode: str) -> torch.Tensor:
    """What one launch on CUDA rows x did, per row: its cluster reductions
    (barriers), the bisection steps warp 0 of a CTA took alone, and the
    length of the list the top-k search gathered for them (-1: none); [B,
    3] int32. The streaming route reports nothing (every entry -1). The
    launch counts in ``family_call.launches``, as any other does."""
    if not x.is_cuda:
        raise ValueError("only a launch on CUDA rows reports its passes")
    stats = torch.full((x.shape[0], 3), -1, dtype=torch.int32,
                       device=x.device)
    _launch(x, 0, k, p, filt, out_mode, stats)
    return stats


def top_k_top_p_sampling_from_probs(
    probs: torch.Tensor,
    top_k,
    top_p,
    *,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    filter_apply_order: str = "top_k_first",
) -> torch.Tensor:
    """Joint top-k + top-p sampling from probabilities [B, V]: top-k, then
    renormalise, then top-p (``top_k_first``), or both pivots on the raw
    probabilities (``joint``). The noise comes from ``seed`` or, if None, a
    seed drawn from ``generator``. Returns tokens [B] int32."""
    if seed is None:
        if generator is None:
            raise ValueError("pass a seed or a torch.Generator")
        seed = draw_seed(generator)
    filt = {"top_k_first": "top_k_top_p_seq",
            "joint": "top_k_top_p_joint"}.get(filter_apply_order)
    if filt is None:
        raise ValueError(f"unknown filter_apply_order {filter_apply_order!r}")
    return family_call(probs.float(), seed, top_k, top_p, filt=filt,
                       out_mode="sample")
