"""Mask-aware key tiles: the tile maps the paged and flash kernels read to
skip the key tiles a mask keeps nothing of and to run the tiles it keeps
whole without it (``ops/attention/kernels/tile_map.py``).

Each map builder (the paged plan's, and the paged wrapper's for a work
mask handed over alone; the flash wrapper's plain map of packed bits and
of a caller's mask hook) against a brute-force reduction, tile by tile, over
random, multi-item, tree and document masks, a single kept pair in a tile,
rows that keep no key, and chunks that are no multiple of 64; the plain
versions, reading the maps as the kernels do (empty tiles dropped, full
tiles unmasked), against JAX's ``_paged_kernel`` / ``_flash_kernel`` in
interpret mode with the same seeded numpy inputs (f32 o and lse to 2e-5,
sums in other orders); ``DevicePlan`` carrying the map. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.ops.attention import reference as jax_reference
from flashinfer_tpu.ops.attention import variants as jax_variants
from flashinfer_tpu.ops.attention.kernels.flash import (
    flash_attention_dense as jax_flash,
)
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.ops.attention import variants as torch_variants
from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
    flash_attention_plain,
    flash_tile_map,
    flash_tile_map_plain,
)
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
    paged_attention_plain,
    paged_tile_map,
)
from flashinfer_tpu_torch.ops.attention.kernels.tile_map import (
    MAP_DROP,
    MAP_KEEP,
    map_counts,
)
from flashinfer_tpu_torch.ops.quantization import packbits, unpackbits
from flashinfer_tpu_torch.utils import TensorLayout

HQ, HKV, D = 4, 2, 32
NHD = TensorLayout.NHD
TOL = 2e-5
DOC = 100  # tokens a document


# ------------------------------------------------------------ the masks

def _requests(kind, rng):
    """(qo_lens, kv_lens, plan keywords, per-request bool masks or None)
    of a small masked batch."""
    if kind == "multi_item":  # a 70-token prefix, 9 items of 13
        prefix, items, n_item = 70, 9, 13
        n = prefix + items * n_item
        tpos = np.tile(np.arange(n_item), 2 * items)
        return [n, n], [n, n], dict(
            causal=True, prefix_len_ptr=np.asarray([prefix, prefix]),
            token_pos_in_items_ptr=tpos,
            token_pos_in_items_len=items * n_item), None
    if kind == "tree":  # 24 draft nodes after 100-200 context tokens
        ctx, draft = rng.integers(100, 200, 2), 24
        masks = []
        for c in ctx:
            anc = np.eye(draft, dtype=bool)
            for i in range(1, draft):
                anc[i] |= anc[rng.integers(0, i)]
            masks.append(np.concatenate([np.ones((draft, c), bool), anc], 1))
        return [draft] * 2, list(ctx + draft), dict(causal=False), masks
    qo = rng.integers(90, 170, 2)
    kv = qo + rng.integers(0, 60, 2)
    q_pos = [np.arange(b - a, b)[:, None] for a, b in zip(qo, kv)]
    k_pos = [np.arange(b)[None, :] for b in kv]
    if kind == "document":
        masks = [qp // DOC == kp // DOC for qp, kp in zip(q_pos, k_pos)]
    elif kind == "single_pair":  # one kept pair a request, in reach
        masks = [np.zeros((a, b), bool) for a, b in zip(qo, kv)]
        for m in masks:
            m[-20, 10] = True
    elif kind == "empty_rows":  # random, rows 3..40 keep no key
        masks = [rng.random((a, b)) > 0.5 for a, b in zip(qo, kv)]
        for m in masks:
            m[3:41] = False
    else:  # random
        masks = [rng.random((a, b)) > 0.5 for a, b in zip(qo, kv)]
    return list(qo), list(kv), dict(causal=True), masks


def _plan_kwargs(masks, kw):
    kw = dict(kw)
    if masks is not None:
        kw["custom_mask"] = np.concatenate([m.ravel() for m in masks])
    return kw


def _table(rng, kv_lens, ps):
    kv = np.asarray(kv_lens)
    pages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    total = int(indptr[-1]) + 3
    return indptr, rng.permutation(total)[: indptr[-1]], kv - (pages - 1) \
        * ps, total


def _paged_plan(kind, seed, tile_q, ps, chunk):
    """(the port's planned wrapper, pool pages, the rng after the plan, the
    plan's arguments and keywords)."""
    rng = np.random.default_rng(seed)
    qo, kv, kw, masks = _requests(kind, rng)
    indptr, idx, last, pages = _table(rng, kv, ps)
    args = (np.concatenate([[0], np.cumsum(qo)]), indptr, idx, last, HQ,
            HKV, D, ps)
    kw = dict(kv_chunk_size=chunk, **_plan_kwargs(masks, kw))
    w = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", device="cpu", tile_q=tile_q)
    w.plan(*args, **kw)
    return w, pages, rng, (args, kw)


# -------------------------------------------------------- brute force

def _paged_brute(dp):
    """The tile map by its definition, tile by tile: over the real rows of
    each 64-row block (inside the q rows, valid) and the keys of each
    64-key tile in reach (inside the span, causal, the window), whether
    the work mask keeps one and whether it drops one."""
    m = dp.meta
    wm = dp.work_mask.numpy()
    plan = dp.segment("plan").numpy().reshape(12, -1).astype(np.int64)
    valid = dp.segment("row_valid").numpy() != 0
    T, tq, chunk = wm.shape
    rb_n, nt = -(-tq // 64), -(-chunk // 64)
    out = np.zeros((T, rb_n, nt), np.uint8)
    for w in range(T):
        req, qt, qs, ks, ke, qpb = plan[[0, 1, 3, 5, 6, 9], w]
        span = max(ke - ks, 0) if req >= 0 else 0
        for rb in range(rb_n):
            for kt in range(nt):
                bits = 0
                for r in range(rb * 64, min(tq, rb * 64 + 64)):
                    if qs + r >= len(valid) or not valid[qs + r]:
                        continue
                    tok = qpb + (qt * tq + r) // m.gqa_group
                    for lk in range(kt * 64, min(chunk, kt * 64 + 64)):
                        pos = ks + lk
                        if lk >= span or (m.causal and pos > tok) or (
                                m.window_left >= 0
                                and pos < tok - m.window_left):
                            continue
                        bits |= MAP_KEEP if wm[w, r, lk] else MAP_DROP
                out[w, rb, kt] = bits
    return out


def _flash_brute(qo, kv, hq, hkv, causal, window, keep_fn, map_heads):
    """The flash tile map by its definition: over the packed rows (token *
    group + head in group) of each 64-row block and the keys of each
    64-key tile in reach, whether ``keep_fn(q_pos, kv_pos, head)`` (a
    tile's worth of them) keeps one and drops one; with ``map_heads`` 1
    at head 0."""
    group = hq // hkv
    rows = qo * group
    rb_n, nt = -(-rows // 64), -(-kv // 64)
    out = np.zeros((map_heads, rb_n, nt), np.uint8)
    for hm in range(map_heads):
        for rb in range(rb_n):
            pr = np.arange(rb * 64, min(rows, rb * 64 + 64))
            tok = pr // group
            head = hm * group + pr % group if map_heads > 1 else 0 * pr
            q_pos = kv - qo + tok
            for kt in range(nt):
                k_pos = np.arange(kt * 64, min(kv, kt * 64 + 64))
                reach = np.ones((len(pr), len(k_pos)), bool)
                if causal:
                    reach &= k_pos[None] <= q_pos[:, None]
                if window >= 0:
                    reach &= k_pos[None] >= q_pos[:, None] - window
                keep = keep_fn(q_pos[:, None], k_pos[None], head[:, None])
                out[hm, rb, kt] = (MAP_KEEP * (reach & keep).any()
                                   | MAP_DROP * (reach & ~keep).any())
    return out


# ------------------------------------------------------ the map builders

PAGED_CASES = {  # kind: (tile_q, page, chunk)
    "random": (64, 8, 128),
    "multi_item": (64, 8, 96),
    "tree": (16, 8, 64),
    "document": (128, 16, 128),
    "single_pair": (64, 8, 128),
    "empty_rows": (16, 8, 64),
    "odd_chunk": (64, 8, 40),  # a chunk that is no multiple of 64
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_map_builders_match_brute_force(case):
    """The plan's map (built on the host at plan time) and the wrapper's
    route for a work mask handed over alone (``paged_tile_map`` on the
    mask's device, here the CPU) equal the brute-force map."""
    tile_q, ps, chunk = PAGED_CASES[case]
    kind = "random" if case == "odd_chunk" else case
    w, _, _, _ = _paged_plan(kind, len(case), tile_q, ps, chunk)
    dp = w.device_plan
    m = dp.meta
    assert dp.tile_map is not None and m.kv_chunk_size == chunk
    brute = _paged_brute(dp)
    assert np.array_equal(dp.tile_map.numpy(), brute)
    derived = paged_tile_map(dp.segment("plan"), dp.work_mask,
                             tile_q=m.tile_q, group=m.gqa_group,
                             causal=m.causal, window_left=m.window_left,
                             q_rows=m.bucket_rows,
                             row_valid=dp.segment("row_valid"))
    assert np.array_equal(derived.numpy(), brute)
    counts = map_counts(dp.tile_map)
    if case == "single_pair":  # one partial tile a request, nothing full
        assert counts["partial"] == 2 and counts["full"] == 0
    elif case in ("document", "multi_item"):
        assert counts["empty"] > 0 and counts["full"] > 0


def _doc_hook(variants):
    return variants.AttentionVariant(
        name="doc", logits_mask=lambda p, qp, kp, h: p["doc"][qp]
        == p["doc"][kp])


def _head_hook(variants):  # even heads: documents of 37; odd: of 53
    return variants.AttentionVariant(
        name="head_doc", logits_mask=lambda p, qp, kp, h: (
            (h % 2 == 0) & (p["doc"][qp] == p["doc"][kp]))
        | ((h % 2 == 1) & (p["doc2"][qp] == p["doc2"][kp])))


def _doc_params(n, conv):
    pos = np.arange(n + 64)
    return {"doc": conv((pos // DOC).astype(np.int32)),
            "doc2": conv((pos // 53).astype(np.int32))}


FLASH_CASES = {  # name: (qo, kv, causal, window, mask)
    "random_bits": (70, 150, True, -1, "random"),
    "doc_bits": (160, 200, True, -1, "doc"),
    "doc_bits_window": (160, 200, True, 50, "doc"),
    "single_pair": (60, 130, False, -1, "single"),
    "empty_rows": (90, 100, True, -1, "empty_rows"),
    "doc_hook": (160, 200, True, -1, "hook"),
    "head_hook": (160, 200, True, -1, "head_hook"),
}


def _flash_mask(name, rng):
    """(keyword arguments of the flash call, keep_fn of the brute force,
    map heads) of one flash case."""
    qo, kv, causal, window, mask = FLASH_CASES[name]
    q_pos = np.arange(kv - qo, kv)[:, None]
    k_pos = np.arange(kv)[None, :]
    kw = dict(causal=causal, window_left=window)
    if mask in ("hook", "head_hook"):
        params = _doc_params(kv, torch.from_numpy)
        kw.update(variant=(_doc_hook if mask == "hook" else _head_hook)(
            torch_variants), variant_params=params)
        hook = kw["variant"].logits_mask

        def keep_fn(qp, kp, h):
            return hook(params, torch.from_numpy(qp), torch.from_numpy(kp),
                        torch.from_numpy(np.asarray(h))).numpy()
        return kw, keep_fn, (HKV if mask == "head_hook" else 1)
    if mask == "doc":
        dense = q_pos // DOC == k_pos // DOC
    elif mask == "single":
        dense = np.zeros((qo, kv), bool)
        dense[40, 100] = True
    else:
        dense = rng.random((qo, kv)) > 0.5
        if mask == "empty_rows":
            dense[10:30] = False
    kw["custom_mask"] = packbits(torch.from_numpy(dense.reshape(-1)))

    def keep_fn(qp, kp, h):
        return np.broadcast_to(dense[qp - (kv - qo), kp],
                               np.broadcast(qp, kp, h).shape)
    return kw, keep_fn, 1


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_map_builders_match_brute_force(name):
    """The flash wrapper's plain map (packed bits, a caller's mask hook at
    one head or a head each kv head) equals the brute-force map."""
    qo, kv, causal, window, _ = FLASH_CASES[name]
    kw, keep_fn, heads = _flash_mask(name, np.random.default_rng(3))
    got = flash_tile_map_plain(qo, kv, HQ, HKV, map_heads=heads, **kw)
    assert np.array_equal(got.numpy(), _flash_brute(
        qo, kv, HQ, HKV, causal, window, keep_fn, heads))
    if heads == 1 and "variant" in kw:  # the hook at one head, or each
        each = flash_tile_map_plain(qo, kv, HQ, HKV, map_heads=HKV, **kw)
        assert all(torch.equal(each[h], got[0]) for h in range(HKV))
    if "custom_mask" in kw:  # the wrapper's map on a CPU tensor
        assert torch.equal(flash_tile_map(qo, kv, HQ, HKV, device="cpu",
                                          **kw), got)


# ------------------------------------------------ the kernels' function

def _cache(rng, pages, ps):
    """(JAX's (k, v), the port's (k, v)) NHD over the same values."""
    xs = [rng.standard_normal((pages, ps, HKV, D)).astype(np.float32)
          for _ in range(2)]
    return (tuple(jnp.asarray(x) for x in xs),
            tuple(torch.from_numpy(x) for x in xs))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind,tile_q,chunk", [("multi_item", 64, 96),
                                               ("tree", 16, 64),
                                               ("document", 64, 128),
                                               ("document", 16, 64)])
def test_paged_plain_with_the_map_matches_jax(kind, tile_q, chunk):
    """The port's wrapper on the CPU (the paged kernel's plain version
    reading the plan's tile map: the tiles it calls empty dropped, those it
    calls full unmasked) against JAX's wrapper on its Pallas kernel in
    interpret mode, which computes every tile; the plans' blobs and work
    masks are equal."""
    w, pages, rng, (args, kw) = _paged_plan(kind, 11, tile_q, 8, chunk)
    jw = jax_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", backend="pallas", tile_q=tile_q)
    jw.plan(*args, **kw)
    dp = w.device_plan
    assert np.array_equal(np.asarray(jw.device_plan.blob), dp.blob.numpy())
    assert np.array_equal(np.asarray(jw.device_plan.work_mask).view(
        np.uint8), dp.work_mask.numpy())
    counts = map_counts(dp.tile_map)
    assert counts["full"] > 0 and (kind == "tree" or counts["empty"] > 0)
    jc, tc = _cache(rng, pages, 8)
    q = rng.standard_normal((dp.meta.nnz, HQ, D)).astype(np.float32)
    got = w.run(torch.from_numpy(q), tc, return_lse=True)
    want = jw.run(jnp.asarray(q), jc, return_lse=True, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("name", ["doc_bits", "doc_bits_window", "doc_hook",
                                  "head_hook"])
def test_flash_plain_with_the_map_matches_jax(name):
    """``flash_attention_dense`` on the CPU (the plain version reading the
    mask's tile map) against JAX's flash kernel in interpret mode with the
    same mask (packed bits, or the same hook in jnp); the hook that reads
    the head against JAX's oracle, since JAX's kernel hands every hook
    head 0 (its per-head leaves come blocked to the head)."""
    qo, kv, causal, window, mask = FLASH_CASES[name]
    rng = np.random.default_rng(5)
    kw, _, heads = _flash_mask(name, rng)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((qo, HQ, D), (kv, HKV, D), (kv, HKV, D)))
    tmap = flash_tile_map(qo, kv, HQ, HKV, device="cpu", **kw)
    counts = map_counts(tmap)
    assert counts["empty"] > 0 and counts["full"] > 0
    got = flash_attention_dense(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    jkw = dict(causal=causal, window_left=window)
    if "custom_mask" in kw:  # JAX's kernel takes the bool matrix
        jkw["custom_mask"] = jnp.asarray(unpackbits(
            kw["custom_mask"], qo * kv).reshape(qo, kv).numpy())
    else:
        jkw["variant"] = (_doc_hook if mask == "hook" else _head_hook)(
            jax_variants)
        jkw["variant_params"] = _doc_params(kv, jnp.asarray)
    jqkv = [jnp.asarray(x) for x in (q, k, v)]
    want = (jax_reference.attention_reference(*jqkv, **jkw)
            if mask == "head_hook" else jax_flash(*jqkv, interpret=True,
                                                  **jkw))
    _close(got, want)


def test_a_misclassed_tile_shows():
    """The plain versions read the map as the kernels do: a map that calls
    a tile with kept keys empty, or a cut tile full, changes the output
    (so the comparisons above would catch a wrong map)."""
    w, pages, rng, _ = _paged_plan("document", 2, 64, 8, 128)
    dp = w.device_plan
    _, tc = _cache(rng, pages, 8)
    m = dp.meta
    q = torch.from_numpy(rng.standard_normal(
        (HKV, m.bucket_rows, D)).astype(np.float32))
    args = (q, *tc, dp.segment("kv_indices"), dp.segment("plan"))
    kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
              sm_scale=D ** -0.5, row_valid=dp.segment("row_valid"),
              work_mask=dp.work_mask, kv_layout=NHD)
    base = paged_attention_plain(*args, tile_map=dp.tile_map, **kw)
    for cls, flip in ((MAP_KEEP, 0), (MAP_KEEP | MAP_DROP, MAP_KEEP)):
        tm = dp.tile_map.clone()
        at = torch.nonzero(tm == cls)[0]
        tm[tuple(at)] = flip
        o, _ = paged_attention_plain(*args, tile_map=tm, **kw)
        assert not torch.equal(o, base[0])
    # the wrapper refuses a map that does not cover the plan
    with pytest.raises(ValueError, match="does not cover"):
        batch_paged_attention_run(*args, tile_map=dp.tile_map[:, :, :1],
                                  **kw)


def test_device_plan_carries_the_map():
    """``DevicePlan.build`` keeps the map beside the work mask (on the host
    with ``upload=False``), equal to the plan's; an unmasked plan has
    neither; ``run_device_plan`` hands the map to the kernel's wrapper,
    whose result equals the derived map's and the no-map path's."""
    w, pages, rng, _ = _paged_plan("multi_item", 4, 64, 8, 96)
    dp = w.device_plan
    host = dp.tile_map.numpy()
    assert np.array_equal(host, _paged_brute(dp))
    arrays = dict(plan=w._state.plan.prefetch_arrays(),
                  **{n: dp.segment(n).numpy()
                     for n, _, _ in dp.meta.blob_layout()[1:]},
                  work_mask=dp.work_mask.numpy(), tile_map=host)
    again = torch_batch.DevicePlan.build(dp.meta, arrays, "cpu",
                                         upload=False)
    assert torch.equal(again.tile_map, dp.tile_map)
    assert torch.equal(again.blob, dp.blob)
    assert dataclasses.astuple(again.meta) == dataclasses.astuple(dp.meta)
    plain = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", device="cpu")
    idx = np.arange(4)
    plain.plan(np.asarray([0, 20]), np.asarray([0, 4]), idx,
               np.asarray([8]), HQ, HKV, D, 8, causal=True)
    assert plain.device_plan.tile_map is None
    assert plain.device_plan.work_mask is None
    _, tc = _cache(rng, pages, 8)
    q = torch.from_numpy(rng.standard_normal(
        (dp.meta.nnz, HQ, D)).astype(np.float32))
    got = torch_batch.run_device_plan(dp, q, *tc, kv_layout=NHD,
                                      return_lse=True)
    no_map = dataclasses.replace(dp, tile_map=None)  # derived at run()
    again = torch_batch.run_device_plan(no_map, q, *tc, kv_layout=NHD,
                                        return_lse=True)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    m = dp.meta
    qp = torch_batch.pack_queries(dp, q)
    args = (qp, *tc, dp.segment("kv_indices"), dp.segment("plan"))
    kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
              sm_scale=m.sm_scale, row_valid=dp.segment("row_valid"),
              work_mask=dp.work_mask, kv_layout=NHD)
    mapped = batch_paged_attention_run(*args, tile_map=dp.tile_map, **kw)
    bare = batch_paged_attention_run(*args, tile_map=False, **kw)
    _close(mapped, bare, 1e-6)
