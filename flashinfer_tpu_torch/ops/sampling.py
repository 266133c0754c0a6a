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

The public samplers (``sampling_from_probs`` ... ``top_k_mask_logits``) are
the JAX package's functions of the same names, each one ``family_call``.
They take ``indices`` (row i draws from row ``indices[i]``),
``deterministic`` and ``backend`` as JAX's do (the kernel is deterministic,
and the backend is the rows' device: the kernel on CUDA rows, the plain
version on CPU rows); randomness comes from ``seed`` (an int, or a
one-element int32 tensor on the rows' device) or a ``generator`` that draws
one, in place of JAX's PRNG key. ``chain_speculative_sampling`` verifies
draft tokens as JAX's does; its acceptance uniforms are a murmur3 hash of
the seed, so a CUDA graph can replay it with a seed read from device memory.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional, Tuple, Union

import torch

from flashinfer_tpu_torch import jit

__all__ = [
    "softmax",
    "family_call",
    "family_plain",
    "pivot_search_plain",
    "sampler_route",
    "sampler_stats",
    "sampling_from_probs",
    "sampling_from_logits",
    "top_p_sampling_from_probs",
    "top_k_sampling_from_probs",
    "min_p_sampling_from_probs",
    "top_k_top_p_sampling_from_probs",
    "top_k_top_p_sampling_from_logits",
    "top_p_renorm_probs",
    "top_k_renorm_probs",
    "top_k_mask_logits",
    "chain_speculative_sampling",
    "spec_uniforms",
    "draw_seed",
]

BISECT_ITERS = 32
_FILTS = {"none": 0, "top_k": 1, "top_p": 2, "min_p": 3,
          "top_k_top_p_joint": 4, "top_k_top_p_seq": 5}
_OUTS = {"sample": 0, "renorm": 1, "mask_logits": 2}
_MASK32 = 0xFFFFFFFF


def _row_param(x, batch: int, dtype, device) -> torch.Tensor:
    """Scalar, [B] or [B, 1] -> [B, 1]. A Python number is filled on the
    device (no host copy, so a CUDA graph can capture it)."""
    if isinstance(x, numbers.Number):
        return torch.full((batch, 1), x, dtype=dtype, device=device)
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.ndim == 0:
        t = t.expand(batch)
    return t.reshape(batch, 1)


def softmax(logits: torch.Tensor,
            temperature: Union[float, torch.Tensor] = 1.0, *,
            enable_pdl: Optional[bool] = None) -> torch.Tensor:
    """Temperature softmax in f32; rows with temperature 0 give a one-hot of
    the argmax (split evenly over ties). ``enable_pdl``, a launch hint, is
    accepted and ignored (plain PyTorch)."""
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


def _seed_of(seed, generator):
    if seed is None:
        if generator is None:
            raise ValueError("pass a seed or a torch.Generator")
        seed = draw_seed(generator)
    return seed


def _rows(x: torch.Tensor, indices) -> torch.Tensor:
    if indices is not None:
        x = x[torch.as_tensor(indices, device=x.device).long()]
    return x.float()


def _draw(probs, seed, generator, k, p, filt, indices) -> torch.Tensor:
    return family_call(_rows(probs, indices), _seed_of(seed, generator), k,
                       p, filt=filt, out_mode="sample")


def sampling_from_probs(probs: torch.Tensor, *, indices=None,
                        deterministic: bool = True, backend: str = "auto",
                        seed=None, generator=None) -> torch.Tensor:
    """A categorical draw from each row of (possibly unnormalised)
    probabilities [B, V]. Returns tokens [B] int32."""
    return _draw(probs, seed, generator, 1, 1.0, "none", indices)


def sampling_from_logits(logits: torch.Tensor, *, indices=None,
                         temperature: Union[float, torch.Tensor] = 1.0,
                         deterministic: bool = True, seed=None,
                         generator=None) -> torch.Tensor:
    """A draw from softmax(logits / temperature) per row: the kernel's
    draw on the temperature softmax (JAX adds Gumbel noise to the logits;
    the distribution is the same). Rows with temperature 0 take the argmax
    (the first, on ties), as in JAX."""
    x = _rows(logits, indices)
    t = _row_param(temperature, x.shape[0], torch.float32, x.device)
    tok = family_call(softmax(x, t), _seed_of(seed, generator), 1, 1.0,
                      filt="none", out_mode="sample")
    return torch.where(t[:, 0] > 0, tok, x.argmax(dim=-1).to(torch.int32))


def top_p_sampling_from_probs(probs: torch.Tensor, top_p, *, indices=None,
                              deterministic: bool = True,
                              backend: str = "auto", seed=None,
                              generator=None) -> torch.Tensor:
    """Nucleus sampling: a draw from the smallest top set of mass top_p."""
    return _draw(probs, seed, generator, 1, top_p, "top_p", indices)


def top_k_sampling_from_probs(probs: torch.Tensor, top_k, *, indices=None,
                              deterministic: bool = True,
                              backend: str = "auto", seed=None,
                              generator=None) -> torch.Tensor:
    """A draw from the top_k most probable entries of each row."""
    return _draw(probs, seed, generator, top_k, 1.0, "top_k", indices)


def min_p_sampling_from_probs(probs: torch.Tensor, min_p, *, indices=None,
                              deterministic: bool = True,
                              backend: str = "auto", seed=None,
                              generator=None) -> torch.Tensor:
    """A draw from the entries with p >= min_p * max(p) of each row."""
    return _draw(probs, seed, generator, 1, min_p, "min_p", indices)


def top_k_top_p_sampling_from_probs(
    probs: torch.Tensor,
    top_k,
    top_p,
    *,
    indices=None,
    filter_apply_order: str = "top_k_first",
    deterministic: bool = True,
    backend: str = "auto",
    seed=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Joint top-k + top-p sampling from probabilities [B, V]: top-k, then
    renormalise, then top-p (``top_k_first``), or both pivots on the raw
    probabilities (``joint``). The noise comes from ``seed`` or, if None, a
    seed drawn from ``generator``. Returns tokens [B] int32."""
    filt = {"top_k_first": "top_k_top_p_seq",
            "joint": "top_k_top_p_joint"}.get(filter_apply_order)
    if filt is None:
        raise ValueError(f"unknown filter_apply_order {filter_apply_order!r}")
    return _draw(probs, seed, generator, top_k, top_p, filt, indices)


def top_k_top_p_sampling_from_logits(
    logits: torch.Tensor,
    top_k,
    top_p,
    *,
    indices=None,
    filter_apply_order: str = "top_k_first",
    deterministic: bool = True,
    seed=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``top_k_top_p_sampling_from_probs`` on softmax(logits)."""
    return top_k_top_p_sampling_from_probs(
        torch.softmax(logits.float(), dim=-1), top_k, top_p, indices=indices,
        filter_apply_order=filter_apply_order, seed=seed,
        generator=generator)


def top_p_renorm_probs(probs: torch.Tensor, top_p, *,
                       backend: str = "auto") -> torch.Tensor:
    """Each row's top-p set renormalised, everything else 0."""
    return family_call(probs.float(), 0, 1, top_p, filt="top_p",
                       out_mode="renorm")


def top_k_renorm_probs(probs: torch.Tensor, top_k, *,
                       backend: str = "auto") -> torch.Tensor:
    """Each row's top-k set renormalised, everything else 0."""
    return family_call(probs.float(), 0, top_k, 1.0, filt="top_k",
                       out_mode="renorm")


def top_k_mask_logits(logits: torch.Tensor, top_k, *,
                      backend: str = "auto") -> torch.Tensor:
    """Logits outside each row's top-k set set to -inf (in the logits'
    dtype)."""
    return family_call(logits.float(), 0, top_k, 1.0, filt="top_k",
                       out_mode="mask_logits").to(logits.dtype)


# the acceptance uniforms hash seed' = mix(seed ^ salt), so they are not the
# draw's Gumbel noise, which hashes the seed itself
_UNIFORM_SALT = 0x5BD1E995


def spec_uniforms(seed, batch: int, num: int, device=None) -> torch.Tensor:
    """``chain_speculative_sampling``'s acceptance uniforms [batch, num] f32
    in [0, 1): the murmur3 finalizer (twice) of seed' + row * 0x9E3779B9 +
    j * 40503 in uint32 arithmetic, top 24 bits, with seed' the finalizer of
    (the seed's low 32 bits) ^ 0x5BD1E995. ``seed`` is an int or a
    one-element int32 tensor (read on its device: graph-safe)."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(()).long() & _MASK32
    else:
        s = _seed32(seed) & _MASK32
    s = _mix(s ^ _UNIFORM_SALT)
    row = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(num, dtype=torch.int64, device=device)[None, :]
    h = (s + _mul32(row, 0x9E3779B9) + col * 40503) & _MASK32
    return (_mix(_mix(h)) >> 8).float() * (1.0 / (1 << 24))


def chain_speculative_sampling(
    draft_probs: torch.Tensor,
    draft_token_ids: torch.Tensor,
    target_probs: torch.Tensor,
    *,
    seed=None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chained speculative-decoding verification (JAX's function of the
    same name). draft_probs [B, G, V], draft_token_ids [B, G], target_probs
    [B, G + 1, V] (the last row draws the bonus token). Draft j is accepted
    with probability min(1, target / draft at its token) while every draft
    before it was; at the first rejection a token is drawn from max(target
    - draft, 0) (the target row where that is empty), after all G the bonus
    token from the last target row. One draw (kernel 2, no filter) takes
    the resampled or the bonus token of every row.

    Returns (output_token_ids [B, G + 1] int32, -1 after the first
    rejection; accepted draft count [B]; emitted draft count [B], the
    same). The uniforms are ``spec_uniforms`` of the seed, not JAX's
    ``jax.random`` stream."""
    seed = _seed_of(seed, generator)
    ids = draft_token_ids.long()
    draft, target = draft_probs.float(), target_probs.float()
    B, G1, V = target.shape
    G = G1 - 1
    b = torch.arange(B, device=target.device)
    u = spec_uniforms(seed, B, G, target.device)
    p_draft = draft.gather(2, ids[..., None])[..., 0]
    p_target = target[:, :G].gather(2, ids[..., None])[..., 0]
    accept = u < torch.clamp(p_target / p_draft.clamp(min=1e-20), max=1.0)
    rejected = ~accept
    first_rej = torch.where(rejected.any(dim=1),
                            rejected.to(torch.int32).argmax(dim=1),
                            G)  # [B]
    pos = first_rej.clamp(max=G - 1)
    resid = (target[b, pos] - draft[b, pos]).clamp(min=0.0)
    # the target row where the residual is empty
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid,
                        target[b, pos])
    rows = torch.where((first_rej < G)[:, None], resid, target[:, G])
    tok = family_call(rows, seed, 1, 1.0, filt="none", out_mode="sample")
    steps = torch.arange(G1, device=target.device)[None, :]
    fr = first_rej[:, None]
    drafted = torch.cat([ids, ids.new_zeros(B, 1)], dim=1)
    out = torch.where(steps < fr, drafted,
                      torch.where(steps == fr, tok[:, None].long(), -1))
    accepted = first_rej.to(torch.int32)
    return out.to(torch.int32), accepted, accepted
