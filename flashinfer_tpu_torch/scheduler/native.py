"""ctypes bindings of the host runtime: the C++ planner and page pool.

Counterpart of ``flashinfer_tpu/scheduler/native.py`` over the port's copy
of the C sources (``csrc/host/``, built by ``jit.get_native_runtime``).
``native_plan_attention`` returns the port's ``AttentionPlan``, equal field
by field to what the NumPy planner (``scheduler/plan.py``, the spec) gives
for the same arguments. ``PagePool`` allocates in C++ where the runtime
builds, and is the Python pool (``scheduler/page_pool.py``, the same
allocation order) where it does not.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from flashinfer_tpu_torch.jit import get_native_runtime
from flashinfer_tpu_torch.scheduler import page_pool as _py_pool

__all__ = ["native_plan_available", "native_plan_attention", "PagePool"]


class _FiPlanSizes(ctypes.Structure):
    _fields_ = [
        ("tile_q", ctypes.c_int64),
        ("kv_chunk_size", ctypes.c_int64),
        ("num_work_items", ctypes.c_int64),
        ("total_rows", ctypes.c_int64),
        ("num_valid_items", ctypes.c_int64),
        ("batch_size", ctypes.c_int64),
        ("page_size", ctypes.c_int64),
        ("gqa_group", ctypes.c_int64),
    ]


_i64 = ctypes.c_int64
_vp = ctypes.c_void_p  # every pointer: passed as an address (no ctypes cast)
_configured = False


def _lib() -> Optional[ctypes.CDLL]:
    global _configured
    lib = get_native_runtime()
    if lib is None or _configured:
        return lib
    for name, res, args in (
        ("fi_plan_create", _vp, [_vp, _i64, _vp, _vp, _i64, _vp, _i64, _i64,
                                 _i64, _i64, _i64, _i64, _i64,
                                 ctypes.c_int32]),
        ("fi_plan_sizes", None, [_vp, ctypes.POINTER(_FiPlanSizes)]),
        ("fi_plan_export", None, [_vp] * 12),
        ("fi_plan_destroy", None, [_vp]),
        ("fi_page_pool_create", _vp, [_i64, _i64]),
        ("fi_page_pool_destroy", None, [_vp]),
        ("fi_page_pool_free_pages", _i64, [_vp]),
        ("fi_seq_create", _i64, [_vp]),
        ("fi_seq_extend", ctypes.c_int32, [_vp, _i64, _i64]),
        ("fi_seq_truncate", ctypes.c_int32, [_vp, _i64, _i64]),
        ("fi_seq_release", None, [_vp, _i64]),
        ("fi_seq_len", _i64, [_vp, _i64]),
        ("fi_seq_num_pages", _i64, [_vp, _i64]),
        ("fi_seq_pages", None, [_vp, _i64, _vp]),
        ("fi_batch_export", None, [_vp, _vp, _i64, _vp, _vp, _vp]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _configured = True
    return lib


def native_plan_available() -> bool:
    return _lib() is not None


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.int64))


def _ptr(a: Optional[np.ndarray]) -> Optional[int]:
    return a.ctypes.data if a is not None else None


def native_plan_attention(
    qo_indptr,
    kv_lens,
    *,
    qo_token_lens=None,
    gqa_group: int = 1,
    kv_indptr=None,
    page_size: int = 1,
    tile_q: int = 128,
    kv_chunk_size: Optional[int] = None,
    max_kv_chunk_size: int = 4096,
    min_kv_chunk_size: int = 256,
    target_num_items: Optional[int] = None,
    work_capacity: Optional[int] = None,
    causal: bool = False,
):
    """``plan.plan_attention`` on the C++ planner (same arguments, same
    ``AttentionPlan``). Raises ``RuntimeError`` where the runtime is absent
    and ``ValueError`` on arguments the planner refuses (as the NumPy
    planner does) or a plan above ``work_capacity``."""
    from flashinfer_tpu_torch.scheduler.plan import AttentionPlan

    lib = _lib()
    if lib is None:
        raise RuntimeError("the native planner is unavailable (no C++ "
                           "compiler built the host runtime)")
    qo_indptr = _as_i64(qo_indptr)
    kv_lens = _as_i64(kv_lens)
    batch = len(kv_lens)
    # the C side reads these lengths without checking them
    if qo_indptr.shape != (batch + 1,):
        raise ValueError(f"qo_indptr has shape {qo_indptr.shape}, want "
                         f"({batch + 1},)")
    tok = _as_i64(qo_token_lens) if qo_token_lens is not None else None
    kvp = _as_i64(kv_indptr) if kv_indptr is not None else None
    if tok is not None and tok.shape != (batch,):
        raise ValueError(f"qo_token_lens has shape {tok.shape}, want "
                         f"({batch},)")
    if kvp is not None and kvp.shape != (batch + 1,):
        raise ValueError(f"kv_indptr has shape {kvp.shape}, want "
                         f"({batch + 1},)")
    handle = lib.fi_plan_create(
        _ptr(qo_indptr), batch, _ptr(kv_lens), _ptr(tok), gqa_group,
        _ptr(kvp), page_size, tile_q, kv_chunk_size or 0,
        max_kv_chunk_size, min_kv_chunk_size, target_num_items or 0,
        work_capacity or 0, int(causal))
    if not handle:
        raise ValueError("the native planner refused the batch (bad "
                         "arguments, or more work items than work_capacity)")
    try:
        sizes = _FiPlanSizes()
        lib.fi_plan_sizes(handle, ctypes.byref(sizes))
        T = sizes.num_work_items
        # the ten [T] rows, then merge_out_row [T * tile_q], in one block
        block = np.empty(T * (10 + sizes.tile_q), np.int32)
        base = block.ctypes.data
        lib.fi_plan_export(handle, *[base + 4 * T * i for i in range(11)])
        arrays = [block[T * i:T * (i + 1)] for i in range(10)]
        merge_out_row = block[10 * T:]
    finally:
        lib.fi_plan_destroy(handle)
    return AttentionPlan(
        tile_q=int(sizes.tile_q),
        kv_chunk_size=int(sizes.kv_chunk_size),
        num_work_items=int(T),
        total_rows=int(sizes.total_rows),
        batch_size=batch,
        page_size=page_size,
        request_indices=arrays[0],
        qo_tile_indices=arrays[1],
        kv_tile_indices=arrays[2],
        qo_start_row=arrays[3],
        qo_tile_len=arrays[4],
        kv_start=arrays[5],
        kv_end=arrays[6],
        kv_page_start=arrays[7],
        num_kv_splits=arrays[8],
        q_pos_base=arrays[9],
        gqa_group=gqa_group,
        merge_out_row=merge_out_row,
        num_valid_items=int(sizes.num_valid_items),
    )


class PagePool:
    """A paged-KV block allocator over the C++ pool
    (``csrc/host/page_pool.cc``), with the Python pool's interface and
    errors. Where the host runtime does not build, constructing one returns
    the Python pool (``scheduler/page_pool.py``), as the JAX package falls
    back to its own; both hand out the same page ids in the same order."""

    def __new__(cls, num_pages: int, page_size: int):
        if _lib() is None:
            return _py_pool.PagePool(num_pages, page_size)
        return super().__new__(cls)

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"bad page pool shape: {num_pages} pages of {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._lib = lib = _lib()
        self._pool = lib.fi_page_pool_create(num_pages, page_size)
        if not self._pool:
            raise MemoryError("fi_page_pool_create failed")
        self._live = set()  # the C side indexes its table unchecked

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool:
            self._lib.fi_page_pool_destroy(pool)
            self._pool = None

    def _seq(self, seq: int) -> int:
        seq = int(seq)
        if seq not in self._live:
            raise KeyError(seq)
        return seq

    @property
    def free_pages(self) -> int:
        return self._lib.fi_page_pool_free_pages(self._pool)

    def create(self) -> int:
        sid = self._lib.fi_seq_create(self._pool)
        self._live.add(sid)
        return sid

    def extend(self, seq: int, new_len: int) -> bool:
        """Grow a sequence to new_len tokens; False on OOM (state unchanged)."""
        return self._lib.fi_seq_extend(self._pool, self._seq(seq),
                                       new_len) == 0

    def truncate(self, seq: int, new_len: int) -> None:
        """Shrink a sequence; frees its tail pages."""
        seq = self._seq(seq)
        length = self.seq_len(seq)
        if not 0 <= new_len <= length:
            raise ValueError(f"truncate to {new_len} of a {length}-token seq")
        self._lib.fi_seq_truncate(self._pool, seq, new_len)

    def release(self, seq: int) -> None:
        if int(seq) in self._live:
            self._lib.fi_seq_release(self._pool, int(seq))
            self._live.discard(int(seq))

    def seq_len(self, seq: int) -> int:
        return self._lib.fi_seq_len(self._pool, self._seq(seq))

    def pages(self, seq: int) -> np.ndarray:
        seq = self._seq(seq)
        out = np.empty(self._lib.fi_seq_num_pages(self._pool, seq), np.int32)
        if len(out):
            self._lib.fi_seq_pages(self._pool, seq, out.ctypes.data)
        return out

    def batch_export(
        self, seqs: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(kv_indptr, kv_indices, kv_last_page_len) for the given sequences."""
        ids = _as_i64([self._seq(s) for s in seqs])
        n = len(ids)
        total = sum(self._lib.fi_seq_num_pages(self._pool, int(s))
                    for s in ids)
        indptr = np.empty(n + 1, np.int32)
        indices = np.empty(max(total, 1), np.int32)
        last = np.empty(max(n, 1), np.int32)
        self._lib.fi_batch_export(self._pool, _ptr(ids), n, _ptr(indptr),
                                  _ptr(indices), _ptr(last))
        return indptr, indices[:total], last[:n]

