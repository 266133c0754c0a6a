"""The paged-attention surface: custom and multi-item masks, ALiBi, the soft
cap, a caller's own hooks, sinks, ragged KV, small pages, a derived KV chunk
and JAX's positional constructors. The port (the paged kernel's plain
version on the CPU, and its "reference" backend) against the JAX package's
wrappers with the same seeded numpy inputs.

Each case is held to JAX's Pallas path, except ALiBi at a group of 3, held
to JAX's reference (a quirk of JAX's kernel, below). Tolerances: f32 o and
lse to 2e-5 (sums in other orders); e4m3 caches to
1e-2 (both round q and P to bf16, against other maxima), as
``tests/test_torch_attention.py`` holds them. Where the plan is JAX's
(masks, small pages, ragged KV, a decode plan's derived chunk) the blob,
the meta and the work mask equal JAX's bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.ops.attention import pod as jax_pod
from flashinfer_tpu.ops.attention import variants as jax_variants
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.ops.attention import pod as torch_pod
from flashinfer_tpu_torch.ops.attention import variants as torch_variants
from flashinfer_tpu_torch.scheduler import plan as torch_plan
from flashinfer_tpu_torch.utils import TensorLayout

HQ, HKV, D = 4, 2, 32
TOL = {"f32": 2e-5, "e4m3": 1e-2}


def _table(rng, kv_lens, ps, extra=3):
    pages = -(-np.asarray(kv_lens) // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    total = int(indptr[-1]) + extra
    indices = rng.permutation(total)[: indptr[-1]]
    last = np.asarray(kv_lens) - (pages - 1) * ps
    return indptr, indices, last, total


def _cache(rng, pages, ps, layout="HND", dtype="f32", hkv=HKV):
    """(JAX's (k, v), the port's (k, v)) over the same values."""
    shape = (pages, hkv, ps, D) if layout == "HND" else (pages, ps, hkv, D)
    jax_kv, torch_kv = [], []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if dtype == "e4m3":
            x = x.to(torch.float8_e4m3fn)
            jax_kv.append(jnp.asarray(
                x.view(torch.int8).numpy().view(jnp.float8_e4m3fn)))
        else:
            jax_kv.append(jnp.asarray(x.numpy()))
        torch_kv.append(x)
    return tuple(jax_kv), tuple(torch_kv)


def _wrappers(name, ctor=(), jkw=None, tkw=None, jax_backend="pallas"):
    """JAX's wrapper (on its Pallas kernel, or its reference), the port's on
    its kernel's plain version and on its reference."""
    jcls, tcls = getattr(jax_batch, name), getattr(torch_batch, name)
    return (jcls(*ctor, backend=jax_backend, **(jkw or {})),
            tcls(*ctor, device="cpu", **(tkw or {})),
            tcls(*ctor, backend="reference", device="cpu", **(tkw or {})))


def _plan(ws, *args, vparams=None, **kw):
    for i, w in enumerate(ws):
        extra = {}
        if vparams is not None:
            conv = jnp.asarray if i == 0 else torch.from_numpy
            extra["variant_params"] = {k: conv(v) for k, v in vparams.items()}
        w.plan(*args, **kw, **extra)
    return ws


def _close(got, want, tol):
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=tol, atol=tol)


def _check(ws, q, jcache, tcache, tol=2e-5, same_plan=True):
    """Runs the three wrappers and holds the port's two (its kernel's plain
    version and its reference) to JAX's; with ``same_plan`` the blob, meta
    and work mask equal JAX's."""
    jw, ours, ours_ref = ws
    tq = torch.from_numpy(q)
    got = ours.run(tq, tcache, return_lse=True)
    kw = dict(interpret=True) if jw._backend == "pallas" else {}
    want = jw.run(jnp.asarray(q), jcache, return_lse=True, **kw)
    _close(got, want, tol)
    _close(ours_ref.run(tq, tcache, return_lse=True), want, tol)
    if same_plan:
        jdp, tdp = jw.device_plan, ours.device_plan
        assert dataclasses.astuple(jdp.meta) == dataclasses.astuple(tdp.meta)
        assert np.array_equal(np.asarray(jdp.blob), tdp.blob.numpy())
        if jdp.work_mask is None:
            assert tdp.work_mask is None
        else:
            assert np.array_equal(np.asarray(jdp.work_mask).view(np.uint8),
                                  tdp.work_mask.numpy())
    return got


def _prefill_batch(rng, qo_lens, kv_lens, ps, layout="HND", dtype="f32",
                   hq=HQ, hkv=HKV):
    indptr, indices, last, total = _table(rng, kv_lens, ps)
    jc, tc = _cache(rng, total, ps, layout, dtype, hkv)
    qo_indptr = np.concatenate([[0], np.cumsum(qo_lens)])
    q = rng.standard_normal((int(qo_indptr[-1]), hq, D)).astype(np.float32)
    args = (qo_indptr, indptr, indices, last, hq, hkv, D, ps)
    return args, q, jc, tc


# --------------------------------------------------------------- masks

@pytest.mark.parametrize("form,dtype", [("packed", "f32"), ("dense", "f32"),
                                        ("dense", "e4m3")])
def test_custom_mask(form, dtype):
    rng = np.random.default_rng(["packed", "dense"].index(form)
                                + 2 * (dtype == "e4m3"))
    qo_lens, kv_lens = [5, 13, 1], [24, 17, 9]
    ps = 32 if dtype == "e4m3" else 8
    args, q, jc, tc = _prefill_batch(rng, qo_lens, kv_lens, ps, dtype=dtype)
    masks = [rng.random((a, b)) > 0.4 for a, b in zip(qo_lens, kv_lens)]
    flat = np.concatenate([m.ravel() for m in masks])
    if form == "packed":
        kw = dict(packed_custom_mask=np.packbits(flat), mask_indptr=np.
                  concatenate([[0], np.cumsum([m.size for m in masks])]))
    else:
        kw = dict(custom_mask=flat)
    ws = _plan(_wrappers("BatchPrefillWithPagedKVCacheWrapper"), *args,
               kv_len_arr=np.asarray(kv_lens), kv_chunk_size=16, **kw)
    assert ws[1].device_plan.meta.has_mask
    _check(ws, q, jc, tc, tol=TOL[dtype])


def test_multi_item_scoring():
    rng = np.random.default_rng(23)
    prefix, items = 6, [3, 2, 4]
    tpos = [t for n in items for t in range(n)] + [0]
    kv_len = prefix + len(tpos)
    args, q, jc, tc = _prefill_batch(rng, [kv_len], [kv_len], 8)
    ws = _plan(_wrappers("BatchPrefillWithPagedKVCacheWrapper",
                         jkw=dict(tile_q=8), tkw=dict(tile_q=8)),
               *args, causal=True, kv_chunk_size=8,
               prefix_len_ptr=np.asarray([prefix]),
               token_pos_in_items_ptr=np.asarray(tpos),
               token_pos_in_items_len=len(tpos))
    _check(ws, q, jc, tc)
    # a query of item 2 sees the prefix and its own item, not item 1
    m = ws[1]._state.host["req_masks"][0]
    row = prefix + items[0] + 1
    assert m[row, :prefix].all() and not m[row, prefix:prefix + items[0]].any()


# ------------------------------------------------------------ variants

@pytest.mark.parametrize("hq,alibi,cap", [(4, True, 0.0), (4, True, 3.0),
                                          (4, False, 3.0), (6, True, 0.0)])
def test_alibi_and_soft_cap(hq, alibi, cap):
    """ALiBi at group 2 (and with the soft cap), the soft cap alone; group 3
    only against JAX's reference: JAX's Pallas kernel takes ALiBi's head as
    the row's index in its tile modulo the group, which is not the row's
    head where tile_q (here 32) is no multiple of the group (ROADMAP Queue
    3, known quirks)."""
    rng = np.random.default_rng([hq, alibi, int(cap)])
    args, q, jc, tc = _prefill_batch(rng, [11, 6], [30, 6], 8, hq=hq)
    var = dict(jkw={}, tkw={})
    vparams = None
    if alibi:
        var = dict(jkw=dict(variant=jax_variants.make_default_variant(
                       use_alibi=True, logits_soft_cap=cap)),
                   tkw=dict(variant=torch_variants.make_default_variant(
                       use_alibi=True, logits_soft_cap=cap)))
        vparams = {"alibi_slopes": (0.5 ** np.arange(1, hq + 1)).astype(
            np.float32)}
    ws = _plan(_wrappers("BatchPrefillWithPagedKVCacheWrapper", **var,
                         jax_backend="pallas" if hq == 4 else "reference"),
               *args, causal=True, kv_chunk_size=16, logits_soft_cap=cap,
               vparams=vparams)
    assert (ws[1].device_plan.meta.tile_q % (hq // HKV) != 0) == (hq == 6)
    _check(ws, q, jc, tc)


def _hook_variant(variants):
    """A variant of the caller's own, in either package: q scaled, a head-
    and position-dependent bias, every fifth key masked."""
    return variants.AttentionVariant(
        name="custom",
        query_transform=lambda p, q: q * p["qs"],
        logits_transform=lambda p, s, qp, kp, h: (
            s + 0.25 * h - 0.01 * (qp - kp)),
        logits_mask=lambda p, qp, kp, h: kp % 5 != 3,
    )


def test_callers_own_hooks_on_the_plain_route():
    rng = np.random.default_rng(41)
    args, q, jc, tc = _prefill_batch(rng, [9, 4], [20, 15], 8)
    ws = _plan(_wrappers(
        "BatchPrefillWithPagedKVCacheWrapper",
        jkw=dict(variant=_hook_variant(jax_variants)),
        tkw=dict(variant=_hook_variant(torch_variants))),
        *args, causal=True, kv_chunk_size=8,
        vparams={"qs": np.asarray(1.5, np.float32)})
    _check(ws, q, jc, tc)


def test_sink_wrapper_with_window():
    rng = np.random.default_rng(42)
    kv_lens = [33, 9, 20]
    indptr, indices, last, total = _table(rng, kv_lens, 8)
    jc, tc = _cache(rng, total, 8)
    sink = rng.standard_normal(HQ).astype(np.float32)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    ws = [jax_batch.BatchAttentionWithAttentionSinkWrapper(
        jnp.asarray(sink), backend="pallas")]
    ws += [torch_batch.BatchAttentionWithAttentionSinkWrapper(
               torch.from_numpy(sink), backend=b, device="cpu")
           for b in ("auto", "reference")]
    _plan(ws, np.arange(4), indptr, indices, last, HQ, HKV, D, 8,
          window_left=7, kv_chunk_size=16)
    got = _check(ws, q, jc, tc)
    # the sink joins each row's denominator: its lse is above the batch's
    plain = torch_batch.BatchAttention.run(ws[1], torch.from_numpy(q), tc,
                                           return_lse=True)
    assert bool((got[1] > plain[1]).all())


# ------------------------------------------------- ragged, pages, chunks

@pytest.mark.parametrize("causal", [False, True])
def test_ragged_kv(causal):
    rng = np.random.default_rng([7, causal])
    kv_lens = np.asarray([40, 131, 7])
    qo_lens = np.asarray([5, 9, 3])  # causal: at the tail of their keys
    kv_indptr = np.concatenate([[0], np.cumsum(kv_lens)])
    qo_indptr = np.concatenate([[0], np.cumsum(qo_lens)])
    k, v = (rng.standard_normal((int(kv_indptr[-1]), HKV, D)).astype(
        np.float32) for _ in range(2))
    q = rng.standard_normal((int(qo_indptr[-1]), HQ, D)).astype(np.float32)
    ws = _plan(_wrappers("BatchPrefillWithRaggedKVCacheWrapper"), qo_indptr,
               kv_indptr, HQ, HKV, D, causal=causal, kv_chunk_size=128)
    _check(ws, q, (jnp.asarray(k), jnp.asarray(v)),
           (torch.from_numpy(k), torch.from_numpy(v)))


@pytest.mark.parametrize("ps,layout,mode", [(1, "NHD", "decode"),
                                            (4, "HND", "decode"),
                                            (4, "NHD", "prefill"),
                                            (12, "HND", "prefill")])
def test_small_and_odd_pages(ps, layout, mode):
    """Pages of 1 and 4 take JAX's repack and pages of 12 are planned in
    place (the kernel's gather build reads them), as JAX plans them: the
    blob is JAX's at every size."""
    rng = np.random.default_rng([ps, mode == "decode"])
    kv_lens = [37, 5, 200] if mode == "decode" else [37, 14]
    qo_lens = [1] * 3 if mode == "decode" else [9, 14]
    args, q, jc, tc = _prefill_batch(rng, qo_lens, kv_lens, ps, layout)
    ctor = dict(kv_layout=layout)
    name = "BatchPrefillWithPagedKVCacheWrapper"
    if mode == "decode":
        name, args = "BatchDecodeWithPagedKVCacheWrapper", args[1:]
    ws = _plan(_wrappers(name, jkw=ctor, tkw=ctor), *args,
               causal=mode == "prefill", kv_chunk_size=128)
    assert ws[1].device_plan.meta.page_size == (128 if ps < 8 else ps)
    assert (ws[1].device_plan.repack is None) == (ps >= 8)
    _check(ws, q, jc, tc)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_kv_chunk_none(mode):
    """Decode plans balance as JAX's planner does (the blob is JAX's);
    prefill plans take the port's rule, so their outputs are compared."""
    rng = np.random.default_rng([11, mode == "decode"])
    kv_lens = [150, 45, 300, 9] if mode == "decode" else [140, 40]
    qo_lens = [1] * 4 if mode == "decode" else [70, 40]
    args, q, jc, tc = _prefill_batch(rng, qo_lens, kv_lens, 64)
    name, ctor = "BatchPrefillWithPagedKVCacheWrapper", dict(tile_q=32)
    if mode == "decode":
        name, args, ctor = "BatchDecodeWithPagedKVCacheWrapper", args[1:], {}
    ws = _plan(_wrappers(name, jkw=ctor, tkw=ctor), *args,
               causal=mode == "prefill")
    meta = ws[1].device_plan.meta
    if mode == "decode":
        assert meta.max_splits > 1
    else:  # a few items of one row block a kv head: the floor, 128 keys
        assert meta.kv_major and meta.kv_chunk_size == 128
    _check(ws, q, jc, tc, same_plan=mode == "decode")


def test_prefill_kv_chunk_rule():
    """The largest power of two at most the longest KV that gives one CTA
    an SM, halved no further than 128 keys or the page; the items it
    counts are the plan's."""
    def chunk(kv, ps, kvh, tile_q, sms, qo_rows=(256, 256)):
        rows = np.asarray(qo_rows)
        return torch_batch.prefill_kv_chunk(
            rows, rows, np.asarray([kv] * len(rows)), group=1,
            tile_q=tile_q, page_size=ps, num_kv_heads=kvh, causal=False,
            num_sms=sms)

    # 2 requests of one qo tile; 8 kv heads x 2 row blocks = 16 CTAs an
    # item: 512 keys give 2 * 8 * 16 = 256 >= 132
    assert chunk(4096, 16, 8, 256, 132) == 512
    assert chunk(4096, 16, 8, 256, 16) == 4096
    assert chunk(3000, 16, 8, 256, 10**6) == 128
    assert chunk(100, 16, 8, 256, 132) == 128
    assert chunk(5000, 24, 1, 64, 132, (64, 64)) == 144
    rng = np.random.default_rng(3)
    for causal in (False, True):
        for group, tile_q, c in ((1, 64, 128), (4, 128, 256), (3, 32, 64)):
            qo = rng.integers(0, 300, 5)
            kv = qo + rng.integers(0, 700, 5)
            rows = np.asarray(qo) * group
            padded = -(-rows // tile_q) * tile_q
            plan = torch_plan.plan_attention(
                np.concatenate([[0], np.cumsum(padded)]), kv,
                qo_token_lens=qo, gqa_group=group, page_size=16,
                tile_q=tile_q, kv_chunk_size=c, causal=causal)
            assert torch_batch._count_items(
                padded, qo, kv, group, tile_q, c, causal) == \
                plan.num_valid_items


@pytest.mark.parametrize("ps", [4, 12])
def test_device_plan_carries_the_repack(ps):
    """A plan on repacked pages (under 8 tokens) carries its gather; a plan
    on pages of 12 carries none (the kernel reads them in place). Either
    way ``run_device_plan`` over the caller's own cache (here two layers
    stacked, read at an offset) computes what the wrapper does, and a
    cache of pages other than those the plan addresses is refused."""
    rng = np.random.default_rng([ps, 1])
    args, q, _, (k, v) = _prefill_batch(rng, [5, 9], [37, 14], ps, "NHD")
    w = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        None, "NHD", device="cpu").plan(*args, causal=True,
                                        kv_chunk_size=128)
    tq = torch.from_numpy(q)
    want = w.run(tq, (k, v))
    dp = w.device_plan
    assert (dp.repack is None) == (ps >= 8)
    got = torch_batch.run_device_plan(
        dp, tq, torch.cat([torch.zeros_like(k), k]),
        torch.cat([torch.zeros_like(v), v]), kv_layout=TensorLayout.NHD,
        kv_indices_offset=k.shape[0])
    assert torch.equal(got, want)
    if ps < 8:  # the plan without its gather addresses 128-token pages
        with pytest.raises(ValueError, match=f"pages of {ps} tokens"):
            torch_batch.run_device_plan(
                torch_batch.DevicePlan(dp.blob, dp.meta), tq, k, v,
                kv_layout=TensorLayout.NHD)
    else:  # the same tokens in pages of twice the size
        n = k.shape[0] // 2 * 2
        with pytest.raises(ValueError, match=f"pages of {2 * ps} tokens"):
            torch_batch.run_device_plan(
                dp, tq, k[:n].reshape(n // 2, 2 * ps, *k.shape[2:]),
                v[:n].reshape(n // 2, 2 * ps, *v.shape[2:]),
                kv_layout=TensorLayout.NHD)


# ----------------------------------------------------------- constructors

def test_positional_constructors_compute_as_jax():
    """JAX's wrappers take the reference's workspace buffer, then the
    layout (and POD the backend), positionally; so do the port's. Held to
    JAX's reference backend."""
    rng = np.random.default_rng(5)
    args, q, jc, tc = _prefill_batch(rng, [6, 3], [19, 30], 8, "NHD")
    for name, a in (("BatchPrefillWithPagedKVCacheWrapper", args),
                    ("BatchDecodeWithPagedKVCacheWrapper", args[1:])):
        jw = getattr(jax_batch, name)(None, "NHD", backend="reference")
        tw = getattr(torch_batch, name)(None, "NHD", device="cpu")
        kw = dict(kv_chunk_size=16, causal=a is args)
        qn = q if a is args else q[:2]
        want = jw.plan(*a, **kw).run(jnp.asarray(qn), jc)
        got = tw.plan(*a, **kw).run(torch.from_numpy(qn), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
    indptr, indices, last = args[1:4]
    qp, kp, vp = (rng.standard_normal(s).astype(np.float32)
                  for s in ((5, HQ, D), (12, HKV, D), (12, HKV, D)))
    jw = jax_pod.PODWithPagedKVCacheWrapper(None, "NHD", "reference").plan(
        indptr, indices, last, HQ, HKV, D, 8, kv_chunk_size=16)
    tw = torch_pod.PODWithPagedKVCacheWrapper(None, "NHD", device="cpu").plan(
        indptr, indices, last, HQ, HKV, D, 8, kv_chunk_size=16)
    want = jw.run(*map(jnp.asarray, (qp, kp, vp, q[:2])), jc)
    got = tw.run(*map(torch.from_numpy, (qp, kp, vp, q[:2])), tc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def test_refusals():
    """A non-softmax variant has no paged kernel route (JAX's message);
    its reference backend computes it. 'pallas' names the TPU kernel."""
    rng = np.random.default_rng(9)
    args, q, _, tc = _prefill_batch(rng, [4], [12], 8)
    w = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        variant=torch_variants.FlashSigmoid(), device="cpu")
    w.plan(*args, kv_chunk_size=16)
    with pytest.raises(ValueError, match="non-softmax variants"):
        w.run(torch.from_numpy(q), tc)
    r = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        variant=torch_variants.FlashSigmoid(), backend="reference",
        device="cpu")
    assert torch.isfinite(r.plan(*args, kv_chunk_size=16).run(
        torch.from_numpy(q), tc)).all()
    with pytest.raises(ValueError, match="pallas"):
        torch_batch.BatchAttention(backend="pallas", device="cpu")
