"""The paged attention's split-KV merge and output unpack: the CUDA kernel's
wrapper and its plain PyTorch version.

``run_device_plan`` runs it after the paged kernel. It takes the kernel's
partials (``partial_o [T, kvh, tile_q, dv]``, ``partial_lse [T, kvh,
tile_q]`` f32) and the plan's ``merge_src`` ([rows, max_splits] flat
partial rows, -1 for none; ``scheduler.plan.build_merge_src``) and
``out_map`` ([nnz * group]: the packed row of each (token, head in group))
and returns the attention output in the caller's layout, [nnz, hq,
head_dim_vo] in the partials' dtype, with the merged lse [nnz, hq] f32 when
asked. Output (token t, head h) merges the partials of packed row
``out_map[t * group + h % group]`` of kv head ``h // group``.

The plain version is the JAX package's composition (``gather_merge_states``,
the ``out_map`` gather, the GQA transpose; a single split is one gather). On
the card it is one launch of ``csrc/paged_merge.cu`` (its note says what
bounds it and how the design answers), counted in ``paged_merge.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.ops.attention.state import gather_merge_states

__all__ = ["paged_merge", "paged_merge_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_merge_plain(
    partial_o: torch.Tensor,
    partial_lse: torch.Tensor,
    merge_src: torch.Tensor,
    out_map: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    nnz: int,
    head_dim_vo: int,
    return_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out [nnz, hq, head_dim_vo], lse [nnz, hq] or None) in plain
    PyTorch. A single split (``merge_src`` of one column) is a permutation,
    so one gather takes the partials straight to the output rows (a row
    with no partial reads partial 0 there)."""
    _, kvh, _, dv = partial_o.shape
    out_map = out_map.long()
    if merge_src.shape[1] == 1:
        comb = merge_src[:, 0].long()[out_map].clamp(min=0)
        w_idx, j_idx = comb // tile_q, comb % tile_q
        out = partial_o[w_idx, :, j_idx, :]  # [nnz * group, kvh, dv]
        lse = partial_lse[w_idx, :, j_idx] if return_lse else None
    else:
        merged_o, merged_lse = gather_merge_states(
            partial_o, partial_lse, merge_src, tile_q)
        out = merged_o[out_map]
        lse = merged_lse[out_map] if return_lse else None
    hq = kvh * group
    out = (out.reshape(nnz, group, kvh, dv).permute(0, 2, 1, 3)
           .reshape(nnz, hq, dv)[:, :, :head_dim_vo])
    if lse is not None:
        lse = lse.reshape(nnz, group, kvh).permute(0, 2, 1).reshape(nnz, hq)
    return out, lse


def _lib():
    fn = jit.load("paged_merge").fi_paged_merge
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P,  # o lse merge_src out_map out lse
                       # nnz group T kvh tile_q dv dv_out splits dtype stream
                       I, I, I, I, I, I, I, I, I, P]
        fn.restype = I
    return fn


def paged_merge(
    partial_o: torch.Tensor,
    partial_lse: torch.Tensor,
    merge_src: torch.Tensor,
    out_map: torch.Tensor,
    *,
    tile_q: int,
    group: int,
    nnz: int,
    head_dim_vo: int,
    return_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Merge a plan's split-KV partials into the output (module docstring):
    (out [nnz, hq, head_dim_vo], lse [nnz, hq] f32 or None).

    A CUDA tensor launches the kernel (or raises), on the current stream
    and with no host sync, so a captured CUDA graph replays it; a CPU
    tensor takes ``paged_merge_plain``. On the card the partials are bf16
    or f32, contiguous, with ``tile_q`` rows an item and dv a multiple of
    16 bytes and at most 1024 bytes; ``merge_src`` and ``out_map`` are
    contiguous int32 on the card. The kernel's arithmetic is the plain
    version's: a single split gives its partial bit for bit, more splits
    differ only in the order of the weights' sum; a row with no partial
    gives 0 (lse -inf)."""
    if not partial_o.is_cuda:
        return paged_merge_plain(
            partial_o, partial_lse, merge_src, out_map, tile_q=tile_q,
            group=group, nnz=nnz, head_dim_vo=head_dim_vo,
            return_lse=return_lse)
    T, kvh, tq, dv = partial_o.shape
    if partial_o.dtype not in _DTYPES:
        raise TypeError(f"paged merge takes bf16/f32 partials, got "
                        f"{partial_o.dtype}")
    vec = 16 // partial_o.element_size()
    if tq != tile_q or dv % vec or dv // vec > 64 or not (
            0 < head_dim_vo <= dv):
        raise ValueError(f"partials [{T}, {kvh}, {tq}, {dv}] do not fit "
                         f"tile_q {tile_q} and head_dim_vo {head_dim_vo} "
                         f"(dv a multiple of 16 bytes, at most 1024 bytes)")
    if (partial_lse.dtype != torch.float32
            or tuple(partial_lse.shape) != (T, kvh, tq)):
        raise ValueError(f"partial_lse {partial_lse.dtype} "
                         f"{tuple(partial_lse.shape)} is not f32 "
                         f"[{T}, {kvh}, {tq}]")
    if merge_src.dim() != 2 or out_map.numel() != nnz * group:
        raise ValueError(f"merge_src {tuple(merge_src.shape)} is not "
                         f"[rows, splits], or out_map of {out_map.numel()} "
                         f"is not nnz * group = {nnz * group}")
    for t, name in ((partial_o, "partial_o"), (partial_lse, "partial_lse"),
                    (merge_src, "merge_src"), (out_map, "out_map")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if merge_src.dtype != torch.int32 or out_map.dtype != torch.int32:
        raise TypeError("merge_src and out_map must be int32")
    dev = partial_o.device
    hq = kvh * group
    out = torch.empty(nnz, hq, head_dim_vo, dtype=partial_o.dtype,
                      device=dev)
    lse = (torch.empty(nnz, hq, dtype=torch.float32, device=dev)
           if return_lse else None)
    if nnz == 0:
        return out, lse
    err = _lib()(
        partial_o.data_ptr(), partial_lse.data_ptr(), merge_src.data_ptr(),
        out_map.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), nnz, group, T, kvh, tile_q,
        dv, head_dim_vo, merge_src.shape[1], _DTYPES[partial_o.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    jit.check(err, "paged merge kernel")
    paged_merge.launches += 1
    return out, lse


paged_merge.launches = 0
