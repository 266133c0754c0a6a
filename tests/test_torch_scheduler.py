"""The port's host side against the JAX package: the planner's arrays, the
DevicePlan blob and the page pool's exports are identical on random
batches."""

import dataclasses

import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.scheduler import plan as jax_plan
from flashinfer_tpu.scheduler.native import PagePool as JaxPagePool
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.scheduler import plan as torch_plan
from flashinfer_tpu_torch.scheduler.page_pool import PagePool

PLAN_FIELDS = ("request_indices", "qo_tile_indices", "kv_tile_indices",
               "qo_start_row", "qo_tile_len", "kv_start", "kv_end",
               "kv_page_start", "num_kv_splits", "q_pos_base",
               "merge_out_row")


def _random_batch(rng, batch, page_size, decode):
    """qo_lens, kv_lens and a shuffled page table for one batch."""
    qo = np.ones(batch, np.int64) if decode else rng.integers(1, 40, batch)
    kv = qo + rng.integers(0, 70, batch)
    npages = -(-kv // page_size)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    indices = rng.permutation(int(indptr[-1]) + 5)[: int(indptr[-1])]
    last = ((kv - 1) % page_size) + 1
    return qo, kv, indptr, indices.astype(np.int32), last


def _assert_plans_equal(a, b):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("tile_q", "kv_chunk_size", "num_work_items", "total_rows",
              "num_valid_items", "kv_major"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.prefetch_arrays(), b.prefetch_arrays()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("causal", [False, True])
def test_plan_attention_matches_jax(seed, causal):
    rng = np.random.default_rng(seed)
    batch, ps, group, tile_q = int(rng.integers(1, 6)), 8, 4, 32
    qo, kv, indptr, _, _ = _random_batch(rng, batch, ps, decode=False)
    rows = np.concatenate([[0], np.cumsum(-(-qo * group // tile_q) * tile_q)])
    kw = dict(qo_token_lens=qo, gqa_group=group, kv_indptr=indptr,
              page_size=ps, tile_q=tile_q, kv_chunk_size=32, causal=causal)
    want = jax_plan._plan_attention_numpy(rows, kv, **kw)
    got = torch_plan.plan_attention(rows, kv, **kw)
    _assert_plans_equal(got, want)
    _assert_plans_equal(torch_plan.kv_major_order(got),
                        jax_plan.kv_major_order(want))
    np.testing.assert_array_equal(
        torch_plan.build_merge_src(got.merge_out_row, int(rows[-1])),
        jax_plan.build_merge_src(want.merge_out_row, int(rows[-1])))


def _blob(dplan):
    b = dplan.blob
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_prefill_device_plan_blob_matches_jax(seed, layout):
    rng = np.random.default_rng(10 + seed)
    batch, ps = int(rng.integers(1, 5)), 8
    qo, kv, indptr, indices, last = _random_batch(rng, batch, ps, False)
    qo_indptr = np.concatenate([[0], np.cumsum(qo)])
    args = (qo_indptr, indptr, indices, last, 8, 2, 32, ps)
    kw = dict(causal=True, kv_chunk_size=32)
    want = jax_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout=layout, backend="pallas").plan(*args, **kw).device_plan
    got = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout=layout, device="cpu").plan(*args, **kw).device_plan
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    np.testing.assert_array_equal(_blob(got), _blob(want))


@pytest.mark.parametrize("seed", range(3))
def test_decode_device_plan_blob_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    batch, ps = int(rng.integers(1, 8)), 16
    _, kv, indptr, indices, last = _random_batch(rng, batch, ps, True)
    kv[rng.integers(0, batch)] = 0  # an empty slot, as the engine has
    npages = np.where(kv > 0, -(-kv // ps), 0)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    padded = np.zeros(64, np.int32)
    padded[: int(indptr[-1])] = indices[: int(indptr[-1])]
    args = (indptr, padded, last, 8, 2, 32, ps)
    kw = dict(kv_len_arr=kv, kv_chunk_size=32, work_capacity=64)
    want = jax_batch.BatchDecodeWithPagedKVCacheWrapper(
        kv_layout="NHD", backend="pallas").plan(*args, **kw).device_plan
    got = torch_batch.BatchDecodeWithPagedKVCacheWrapper(
        kv_layout="NHD", device="cpu").plan(*args, **kw).device_plan
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    np.testing.assert_array_equal(_blob(got), _blob(want))
    assert got.meta.max_splits > 1 or int(kv.max()) <= 32


def test_device_plan_segments_match_jax():
    rng = np.random.default_rng(5)
    qo, kv, indptr, indices, last = _random_batch(rng, 3, 8, False)
    qo_indptr = np.concatenate([[0], np.cumsum(qo)])
    args = (qo_indptr, indptr, indices, last, 4, 2, 16, 8)
    want = jax_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", backend="pallas").plan(
            *args, causal=True, kv_chunk_size=16).device_plan
    got = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", device="cpu").plan(
            *args, causal=True, kv_chunk_size=16).device_plan
    for name in ("plan", "kv_indices", "row_src", "merge_out_row", "out_map",
                 "merge_src"):
        ref = want.plan_arrays if name == "plan" else getattr(want, name)
        np.testing.assert_array_equal(got.segment(name).numpy(),
                                      np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_page_pool_matches_jax(seed):
    rng = np.random.default_rng(30 + seed)
    ours, ref = PagePool(40, 8), JaxPagePool(40, 8)
    live = []  # (our seq id, reference seq id)
    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0 or not live:
            live.append((ours.create(), ref.create()))
        elif op == 1:
            a, b = live[rng.integers(0, len(live))]
            n = ours.seq_len(a) + int(rng.integers(0, 20))
            assert ours.extend(a, n) == ref.extend(b, n)
        elif op == 2:
            a, b = live[rng.integers(0, len(live))]
            n = int(rng.integers(0, ours.seq_len(a) + 1))
            ours.truncate(a, n)
            ref.truncate(b, n)
        else:
            a, b = live.pop(rng.integers(0, len(live)))
            ours.release(a)
            ref.release(b)
        assert ours.free_pages == ref.free_pages
        for a, b in live:
            np.testing.assert_array_equal(ours.pages(a), ref.pages(b))
        if live:
            got = ours.batch_export([a for a, _ in live])
            want = ref.batch_export([b for _, b in live])
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_plan_decode_and_prefill_match_jax(group):
    """``plan_decode`` pads each request to one tile of max(8,
    next_pow2(group)) rows; ``plan_prefill`` defaults tile_q to 128: both
    give JAX's plans, field by field."""
    rng = np.random.default_rng(group)
    _, kv, indptr, _, _ = _random_batch(rng, 5, 8, decode=True)
    kw = dict(kv_indptr=indptr, page_size=8, gqa_group=group,
              kv_chunk_size=32)
    got = torch_plan.plan_decode(kv, backend="numpy", **kw)
    assert got.tile_q == max(8, 1 << (group - 1).bit_length())
    _assert_plans_equal(got, jax_plan.plan_decode(kv, **kw))
    qo, kv, indptr, _, _ = _random_batch(rng, 3, 8, decode=False)
    rows = np.concatenate([[0], np.cumsum(-(-qo * group // 128) * 128)])
    kw = dict(qo_token_lens=qo, gqa_group=group, kv_indptr=indptr,
              page_size=8, causal=True)
    got = torch_plan.plan_prefill(rows, kv, backend="numpy", **kw)
    assert got.tile_q == 128
    _assert_plans_equal(got, jax_plan.plan_prefill(rows, kv, **kw))
