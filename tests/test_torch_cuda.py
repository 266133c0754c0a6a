"""The port's kernels on the card against their plain versions, at small
shapes and over the options the engine does not reach. They skip on a
machine without a CUDA device; on the H100 run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the machine
with the card does not have).

Tolerances: f32 outputs agree to 1e-4 (other summation orders); bf16,
e4m3 and int8 attention outputs (paged and MLA) to 2e-2, a bf16 rounding
step of P taken against a running rather than a global maximum (the flash
kernel's bf16 o to 2^-6 |ref| + 2^-8 and lse to 1e-3, for that reason);
grouped
GEMM outputs to one bf16 step (2^-7 relative) or 1e-3 relative in f32,
plus 1e-3 of the output's rms (f32 sums in other orders); fused MoE to
2e-2 of its largest output (bf16 intermediates on both sides)."""

import math

import numpy as np
import pytest
import torch

from flashinfer_tpu_torch.ops.attention import batch as attn_batch
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
    paged_attention_plain,
)
from flashinfer_tpu_torch.ops.norm import (
    fused_add_rmsnorm,
    fused_add_rmsnorm_plain,
    rmsnorm,
    rmsnorm_plain,
)
from flashinfer_tpu_torch.ops import sampling as sampling_mod
from flashinfer_tpu_torch.ops.sampling import (
    family_call,
    family_plain,
    sampler_route,
)
from flashinfer_tpu_torch.utils import TensorLayout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(mode, ps, hq, hkv, d, rng, tile_q=None):
    if mode == "decode":
        kv = rng.integers(1, 300, 5)
        qo = np.ones(5, np.int64)
    else:
        qo = rng.integers(20, 90, 3)
        kv = qo + rng.integers(0, 60, 3)
    npages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1]) + 3
    indices = rng.permutation(pages)[: int(indptr[-1])]
    last = ((kv - 1) % ps) + 1
    cls = (attn_batch.BatchDecodeWithPagedKVCacheWrapper if mode == "decode"
           else attn_batch.BatchPrefillWithPagedKVCacheWrapper)
    w = cls(device="cuda", tile_q=tile_q)
    args = (indptr, indices, last, hq, hkv, d, ps)
    if mode != "decode":
        args = (np.concatenate([[0], np.cumsum(qo)]),) + args
    w.plan(*args, kv_chunk_size=64, causal=mode != "decode")
    return w.device_plan, pages, int(qo.sum())


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("mode,tile_q", [("decode", None),
                                         ("prefill", 16), ("prefill", 64)])
def test_paged_kernel_matches_plain(dev, qdt, kv, layout, mode, tile_q):
    # its caches and q come from the global CUDA generator, which PyTorch
    # seeds anew in every process: each run draws other numbers
    rng = np.random.default_rng(0)
    ps, hq, hkv, d = 16, 8, 2, 64
    dp, pages, nnz = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    shape = ((2 * pages, hkv, ps, d) if layout == "HND"
             else (2 * pages, ps, hkv, d))
    kc, vc = (torch.randn(shape, device=dev) for _ in range(2))
    if kv == "int8":
        kc, vc = ((t * 20).round().clamp(-127, 127).to(torch.int8)
                  for t in (kc, vc))
    elif kv == "e4m3":
        kc, vc = (t.to(torch.float8_e4m3fn) for t in (kc, vc))
    else:
        kc, vc = kc.to(qdt), vc.to(qdt)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev).to(qdt)
    # an int8 cache holds values x 20: its dequant scale 1/20 folds into
    # both scales, as in the file's other int8 tests. Read at x 20, P's bf16
    # rounding at a key whose f32 score lies on a rounding boundary (taken
    # one way by the kernel's sums, the other by the plain version's) moves
    # o by up to ~0.13, past the absolute tolerance near 0
    # (tools/paged_int8_witness.py)
    unit = INT8_UNIT if kv == "int8" else 1.0
    kw = dict(tile_q=dp.meta.tile_q, group=hq // hkv, causal=dp.meta.causal,
              sm_scale=d ** -0.5, k_scale=0.7 * unit, v_scale=1.3 * unit,
              kv_layout=TensorLayout[layout], kv_indices_offset=pages)
    args = (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan"))
    before = batch_paged_attention_run.launches
    o, lse = batch_paged_attention_run(*args, **kw)
    assert batch_paged_attention_run.launches == before + 1
    ref_o, ref_lse = paged_attention_plain(*args, **kw)
    tol = 1e-4 if (qdt == torch.float32 and kv != "e4m3") else 2e-2
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("cap,window", [(0.0, 20), (30.0, -1)])
def test_paged_kernel_soft_cap_and_window(dev, cap, window):
    rng = np.random.default_rng(1)
    dp, pages, nnz = _plan("prefill", 16, 4, 2, 32, rng, 32)
    kc, vc = (torch.randn(2 * pages, 16, 2, 32, device=dev) for _ in "kv")
    q = torch.randn(2, dp.meta.bucket_rows, 32, device=dev) * 3
    kw = dict(tile_q=32, group=2, causal=True, sm_scale=0.3,
              window_left=window, logits_soft_cap=cap,
              kv_indices_offset=pages)
    args = (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan"))
    o, lse = batch_paged_attention_run(*args, **kw)
    ref_o, ref_lse = paged_attention_plain(*args, **kw)
    torch.testing.assert_close(o, ref_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


# int8 caches hold round(20 x) with a scale of 1/20, so their values are
# unit-size like the other kinds' (f32 sums of 256 products of int8-sized
# values differ in their order by more than the f32 tolerance)
INT8_UNIT = 1 / 20


def _paged_caches(dev, gen, layout, kv, qdt, pages, ps, hkv, d, dv):
    """K (d columns) and V (dv columns) paged caches in ``layout``, in q's
    dtype, e4m3 or int8 (to be read with a scale of INT8_UNIT), from
    ``gen`` (the tests here leave the global CUDA generator alone, so the
    tests after them see the numbers they always saw)."""
    out = []
    for width in (d, dv):
        shape = ((pages, hkv, ps, width) if layout == "HND"
                 else (pages, ps, hkv, width))
        x = torch.randn(shape, device=dev, generator=gen)
        if kv == "int8":
            x = (x * 20).round().clamp(-127, 127).to(torch.int8)
        elif kv == "e4m3":
            x = x.to(torch.float8_e4m3fn)
        else:
            x = x.to(qdt)
        out.append(x)
    return out


def _paged_check(dev, dp, kc, vc, q, hq, hkv, d, k_scale=1.0, v_scale=1.0,
                 **kw):
    """The kernel against its plain version on every row of a planned
    batch (padding rows: the identity in both), with the plan's
    row_valid; one launch counted. An int8 cache's scales take INT8_UNIT."""
    unit = INT8_UNIT if kc.dtype == torch.int8 else 1.0
    kw = dict(tile_q=dp.meta.tile_q, group=hq // hkv, causal=dp.meta.causal,
              sm_scale=d ** -0.5, row_valid=dp.segment("row_valid"),
              k_scale=k_scale * unit, v_scale=v_scale * unit, **kw)
    args = (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan"))
    before = batch_paged_attention_run.launches
    o, lse = batch_paged_attention_run(*args, **kw)
    assert batch_paged_attention_run.launches == before + 1
    ref_o, ref_lse = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    f32 = q.dtype == torch.float32 and kc.dtype != torch.float8_e4m3fn
    tol = 1e-4 if f32 else 2e-2
    assert o.shape == ref_o.shape and o.dtype == q.dtype
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    return o, lse


@pytest.mark.parametrize("mode,tile_q,layout", [
    ("decode", None, "NHD"), ("decode", None, "HND"), ("prefill", 16, "NHD"),
    ("prefill", 16, "HND"), ("prefill", 64, "NHD")])
def test_paged_kernel_int8_runs_are_bit_identical(dev, mode, tile_q, layout):
    """The int8 / bf16-q shapes of test_paged_kernel_matches_plain that
    failed now and then: 20 launches in one process on the same inputs give
    the same bits, each matching the plain version."""
    rng = np.random.default_rng(20)
    gen = torch.Generator(device=dev).manual_seed(20)
    ps, hq, hkv, d = 16, 8, 2, 64
    dp, pages, _ = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    kc, vc = _paged_caches(dev, gen, layout, "int8", torch.bfloat16,
                           2 * pages, ps, hkv, d, d)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).to(torch.bfloat16)
    runs = [_paged_check(dev, dp, kc, vc, q, hq, hkv, d, k_scale=0.7,
                         v_scale=1.3, kv_layout=TensorLayout[layout],
                         kv_indices_offset=pages) for _ in range(20)]
    for o, lse in runs[1:]:
        assert torch.equal(o, runs[0][0]) and torch.equal(lse, runs[0][1])


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("mode,tile_q", [("decode", None), ("prefill", 64)])
@pytest.mark.parametrize("d,dv", [(256, 256), (192, 128)])
def test_paged_kernel_wide_heads(dev, qdt, kv, layout, mode, tile_q, d, dv):
    """head_dim 256, and d 192 with dv 128 (V at its own width), on the
    tensor cores (bf16 q, e4m3 caches) and the CUDA cores (f32 q)."""
    rng = np.random.default_rng(d + dv)
    gen = torch.Generator(device=dev).manual_seed(d + dv)
    ps, hq, hkv = 16, 8, 2
    dp, pages, _ = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    kc, vc = _paged_caches(dev, gen, layout, kv, qdt, 2 * pages, ps, hkv, d,
                           dv)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).to(qdt)
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d, k_scale=0.7, v_scale=1.3,
                 kv_layout=TensorLayout[layout], kv_indices_offset=pages)


@pytest.mark.parametrize("kv", ["model", "e4m3"])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("tile_q", [8, 16, 64, 256])
def test_paged_kernel_tiles_and_pages(dev, kv, ps, tile_q):
    """Every row-block geometry (one consumer warpgroup below 128 rows, two
    from 128, a padding block skipped) over pages of 8, 16 and 32."""
    rng = np.random.default_rng(ps * tile_q)
    gen = torch.Generator(device=dev).manual_seed(ps * tile_q)
    hq, hkv, d = 8, 2, 128
    mode = "decode" if tile_q == 8 else "prefill"
    dp, pages, _ = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    kc, vc = _paged_caches(dev, gen, "NHD", kv, torch.bfloat16, pages, ps,
                           hkv, d, d)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).bfloat16()
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d)


@pytest.mark.parametrize("ps", [12, 20, 9])
@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("mode,tile_q", [("decode", None), ("prefill", 64)])
@pytest.mark.parametrize("d", [128, 256])
def test_paged_kernel_gathers_pages_not_a_multiple_of_8(dev, ps, kv, layout,
                                                        mode, tile_q, d):
    """Pages of 12, 20 and 9 tokens, which TMA boxes do not tile, read in
    place by the cp.async gather on both tensor-core routes (the swap-AB
    decode tiles and the 64-row prefill tiles), bf16 q over bf16, e4m3
    and linear-int8 caches, against the plain version at the ATTN limits;
    one launch each, no repack."""
    rng = np.random.default_rng([ps, d, mode == "decode"])
    gen = torch.Generator(device=dev).manual_seed(ps * d)
    hq, hkv = 8, 2
    dp, pages, _ = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    assert dp.meta.page_size == ps and dp.repack is None
    kc, vc = _paged_caches(dev, gen, layout, kv, torch.bfloat16, 2 * pages,
                           ps, hkv, d, d)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).bfloat16()
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d, k_scale=0.7, v_scale=1.3,
                 kv_layout=TensorLayout[layout], kv_indices_offset=pages)


@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
def test_paged_kernel_pod_shaped_plan(dev, kv):
    """POD's combined plan: decodes in 256-row tiles (4 real rows each)
    beside a causal chunk at the tail of a long prompt, in one launch."""
    from flashinfer_tpu_torch.ops.attention.batch import pack_queries
    from flashinfer_tpu_torch.ops.attention.pod import (
        PODWithPagedKVCacheWrapper,
    )

    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev).manual_seed(9)
    hq, hkv, d, ps = 8, 2, 128, 16
    kv_lens = rng.integers(40, 400, 6)
    npages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    prompt, chunk = 900, 300
    num_pages = int(indptr[-1]) + -(-prompt // ps)
    perm = rng.permutation(num_pages)
    indices, free = perm[: indptr[-1]], perm[indptr[-1]:]
    w = PODWithPagedKVCacheWrapper(device="cuda").plan(
        indptr, indices, kv_lens - (npages - 1) * ps, hq, hkv, d, ps,
        kv_len_arr=kv_lens, kv_chunk_size=128, prefill_qo_len=chunk,
        prefill_kv_len=prompt, prefill_page_indices=free)
    dp = w._attn.device_plan
    assert dp.meta.tile_q == 256 and dp.meta.causal
    kc, vc = _paged_caches(dev, gen, "HND", kv, torch.bfloat16, num_pages, ps,
                           hkv, d, d)
    q = torch.randn(chunk + len(kv_lens), hq, d, device=dev,
                    generator=gen).bfloat16()
    _paged_check(dev, dp, kc, vc, pack_queries(dp, q), hq, hkv, d,
                 kv_layout=TensorLayout.HND)


@pytest.mark.parametrize("kv", ["model", "e4m3"])
@pytest.mark.parametrize("cap,window", [(0.0, 20), (30.0, -1), (30.0, 50)])
def test_paged_tensor_core_kernel_soft_cap_and_window(dev, kv, cap, window):
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    hq, hkv, d = 4, 2, 64
    dp, pages, _ = _plan("prefill", 16, hq, hkv, d, rng, 128)
    kc, vc = _paged_caches(dev, gen, "NHD", kv, torch.bfloat16, pages, 16,
                           hkv, d, d)
    q = (torch.randn(hkv, dp.meta.bucket_rows, d, device=dev, generator=gen)
         * 3).bfloat16()
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d, window_left=window,
                 logits_soft_cap=cap)


@pytest.mark.parametrize("d", [32, 64])
def test_paged_tensor_core_kernel_narrow_heads(dev, d):
    rng = np.random.default_rng(d)
    gen = torch.Generator(device=dev).manual_seed(d)
    dp, pages, _ = _plan("prefill", 16, 8, 2, d, rng, 16)
    kc, vc = _paged_caches(dev, gen, "HND", "model", torch.bfloat16, pages,
                           16, 2, d, d)
    q = torch.randn(2, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).bfloat16()
    _paged_check(dev, dp, kc, vc, q, 8, 2, d, kv_layout=TensorLayout.HND)


@pytest.mark.parametrize("kv", ["model", "e4m3"])
def test_paged_kernel_in_a_cuda_graph(dev, kv):
    """A decode launch captured in a CUDA graph and replayed on a second
    plan blob of the same shape (new lengths, pages and queries) matches
    its plain version; the call allocates its outputs and nothing else."""
    hq, hkv, d, ps = 32, 8, 128, 16
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)

    def decode_plan(lens):
        npages = -(-lens // ps)
        indptr = np.concatenate([[0], np.cumsum(npages)])
        indices = rng.permutation(400)[: indptr[-1]]
        w = attn_batch.BatchDecodeWithPagedKVCacheWrapper(
            kv_layout="NHD", device="cuda")
        w.plan(indptr, indices, lens - (npages - 1) * ps, hq, hkv, d, ps,
               kv_chunk_size=256, work_capacity=32)
        return w.device_plan

    # the longest request (4 chunks) sets the merge's width: keep it
    plans = [decode_plan(np.concatenate([[900], rng.integers(100, 900, 7)]))
             for _ in range(2)]
    assert plans[0].blob.shape == plans[1].blob.shape
    kc, vc = _paged_caches(dev, gen, "NHD", kv, torch.bfloat16, 400, ps, hkv,
                           d, d)
    dp = plans[0]
    blob = dp.blob.clone()
    dp = attn_batch.DevicePlan(blob, dp.meta)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).bfloat16()
    kw = dict(tile_q=dp.meta.tile_q, group=hq // hkv, causal=False,
              sm_scale=d ** -0.5, row_valid=dp.segment("row_valid"))
    args = (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan"))
    batch_paged_attention_run(*args, **kw)  # builds and loads the library
    torch.cuda.synchronize()
    T = dp.meta.num_work_items
    block = 512  # the caching allocator's rounding
    want_bytes = sum(-(-n // block) * block for n in (
        T * hkv * dp.meta.tile_q * d * 2, T * hkv * dp.meta.tile_q * 4))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = batch_paged_attention_run(*args, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= want_bytes
    del out
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        o, lse = batch_paged_attention_run(*args, **kw)
    blob.copy_(plans[1].blob)
    q.copy_(torch.randn(q.shape, device=dev, generator=gen).bfloat16())
    g.replay()
    ref_o, ref_lse = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ref_o.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _surface_plan(mode, feature, hq, hkv, d, rng, tile_q=None):
    """A planned batch (decode, or causal prefill) for ``feature``: a
    random custom mask ("mask"), ALiBi ("alibi", "alibi_cap": also the soft
    cap) or pages of 12 tokens ("page12", read in place by the kernel's
    cp.async gather). Returns
    the wrapper, the page count and page size of its caller's cache."""
    from flashinfer_tpu_torch.ops.attention.variants import (
        make_default_variant,
    )

    ps = 12 if feature == "page12" else 16
    if mode == "decode":
        kv = rng.integers(1, 300, 5)
        qo = np.ones(5, np.int64)
    else:
        qo = rng.integers(20, 90, 3)
        kv = qo + rng.integers(0, 60, 3)
    npages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1]) + 3
    indices = rng.permutation(pages)[: int(indptr[-1])]
    cls = (attn_batch.BatchDecodeWithPagedKVCacheWrapper if mode == "decode"
           else attn_batch.BatchPrefillWithPagedKVCacheWrapper)
    variant = None
    if feature.startswith("alibi"):
        variant = make_default_variant(
            use_alibi=True, logits_soft_cap=30.0 * (feature == "alibi_cap"))
    w = cls(device="cuda", tile_q=tile_q, variant=variant)
    args = (indptr, indices, ((kv - 1) % ps) + 1, hq, hkv, d, ps)
    kw = dict(kv_chunk_size=64, causal=mode != "decode")
    if mode != "decode":
        args = (np.concatenate([[0], np.cumsum(qo)]),) + args
    if feature == "mask":
        kw["custom_mask"] = np.concatenate(
            [rng.random(a * b) > 0.3 for a, b in zip(qo, kv)])
    w.plan(*args, **kw)
    return w, pages, ps


@pytest.mark.parametrize("feature", ["mask", "alibi", "alibi_cap", "page12"])
@pytest.mark.parametrize("qdt,kv", [(torch.bfloat16, "model"),
                                    (torch.bfloat16, "e4m3"),
                                    (torch.bfloat16, "int8"),
                                    (torch.float32, "model"),
                                    (torch.float32, "int8")])
@pytest.mark.parametrize("mode,tile_q", [("decode", None), ("prefill", 16),
                                         ("prefill", 64)])
def test_paged_kernel_surface_matches_plain(dev, feature, qdt, kv, mode,
                                            tile_q):
    """Masked, ALiBi (group 3: a packed row's head is its index in the
    request modulo the group, not in its tile) and page-12 plans: the swap-
    AB decode tiles, the 64-row prefill tiles and the f32 route against the
    plain version."""
    rng = np.random.default_rng([len(feature), mode == "decode", tile_q or 0])
    gen = torch.Generator(device=dev).manual_seed(len(feature))
    hq, hkv, d = 6, 2, 64
    w, pages, ps = _surface_plan(mode, feature, hq, hkv, d, rng, tile_q)
    dp = w.device_plan
    kc, vc = _paged_caches(dev, gen, "HND", kv, qdt, pages, ps, hkv, d, d)
    layout = TensorLayout.HND
    if feature == "page12":  # planned natively, no repack
        assert dp.meta.page_size == 12 and dp.repack is None
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).to(qdt)
    extra = {}
    if feature.startswith("alibi"):
        extra = dict(variant=w._state.variant, variant_params={
            "alibi_slopes": 0.5 ** torch.arange(1, hq + 1, device=dev)})
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d, kv_layout=layout,
                 work_mask=dp.work_mask, **extra)


def test_paged_kernel_refuses_hooks_and_non_softmax(dev):
    """A variant with hooks of the caller's own runs in the kernel's build
    for it (the variant JIT) and matches the plain version; a hook outside
    the traced subset raises before any build, and a non-softmax variant
    runs in neither."""
    from flashinfer_tpu_torch.ops.attention.variants import (
        AttentionVariant,
        FlashSigmoid,
    )

    rng = np.random.default_rng(8)
    dp, pages, _ = _plan("prefill", 16, 4, 2, 32, rng, 16)
    kc, vc = (torch.randn(pages, 16, 2, 32, device=dev) for _ in "kv")
    q = torch.randn(2, dp.meta.bucket_rows, 32, device=dev)
    args = (q, kc, vc, dp.segment("kv_indices"), dp.segment("plan"))
    kw = dict(tile_q=16, group=2, causal=True, sm_scale=0.2)
    mine = AttentionVariant(
        name="mine", logits_transform=lambda p, s, qp, kp, h: s * 2)
    before = batch_paged_attention_run.launches
    o, lse = batch_paged_attention_run(*args, **kw, variant=mine)
    assert batch_paged_attention_run.launches == before + 1
    ref_o, ref_lse = paged_attention_plain(*args, **kw, variant=mine)
    torch.testing.assert_close(o, ref_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    reduced = AttentionVariant(
        name="reduced", logits_transform=lambda p, s, qp, kp, h: s.softmax(-1))
    with pytest.raises(NotImplementedError, match="softmax"):
        batch_paged_attention_run(*args, **kw, variant=reduced)
    with pytest.raises(ValueError, match="non-softmax variants"):
        batch_paged_attention_run(*args, **kw, variant=FlashSigmoid())


# ---------------------------------------------------- the variant JIT

# the callers' variants the JIT builds (the CPU tests in
# tests/test_torch_variant_jit.py hold the same hooks to JAX's kernels)
JIT_VARIANTS = ["alibi", "doc_mask", "q_out", "sigmoid", "soft_cap"]


def _jit_variant(name, hq, kv_len, dev):
    """(variant, variant_params) of one caller variant written as plain
    torch hooks, and the built-in variant computing the same function, if
    one exists (ALiBi, the sigmoid, the soft cap)."""
    from flashinfer_tpu_torch.ops.attention.single import default_alibi_slopes
    from flashinfer_tpu_torch.ops.attention.variants import (
        AttentionVariant,
        FlashSigmoid,
        make_default_variant,
    )

    if name == "alibi":
        return (AttentionVariant(
            name="caller_alibi",
            logits_transform=lambda p, s, qp, kp, h: (
                s + p["alibi_slopes"][h] * (kp - qp).float())),
            {"alibi_slopes": default_alibi_slopes(hq, dev)},
            make_default_variant(use_alibi=True))
    if name == "doc_mask":  # documents of 37 tokens; the table covers a
        # tile past the keys
        doc = (torch.arange(kv_len + 256, device=dev) // 37).int()
        return (AttentionVariant(
            name="doc_mask",
            logits_mask=lambda p, qp, kp, h: p["doc"][qp] == p["doc"][kp]),
            {"doc": doc}, None)
    if name == "q_out":
        return (AttentionVariant(
            name="q_out", query_transform=lambda p, x: x * p["q_scale"],
            output_transform=lambda p, o: o * 1.5 + p["o_bias"]),
            {"q_scale": torch.tensor(0.75, device=dev), "o_bias": 0.25},
            None)
    if name == "sigmoid":  # bias -log(n) over many keys, as the built-in
        bias = -math.log(kv_len) if kv_len > 256 else -1.0
        return (AttentionVariant(
            name="caller_sigmoid", use_softmax=False,
            logits_transform=lambda p, s, qp, kp, h: torch.reciprocal(
                1.0 + torch.exp(-(s * 0.5 + bias)))),
            None, FlashSigmoid(0.5, bias))
    return (AttentionVariant(
        name="caller_soft_cap",
        logits_transform=lambda p, s, qp, kp, h: 2.0 * torch.tanh(s / 2.0)),
        None, make_default_variant(logits_soft_cap=2.0))


@pytest.fixture(scope="module")
def jit_built():
    """Every library the JIT tests below launch, built at once (one nvcc a
    library, in parallel), as chip_smoke.py's variants phase builds its."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.jit.variant import compile_variant

    dev = torch.device("cuda")
    targets = list(jit.KERNEL_SOURCES)
    for name in JIT_VARIANTS:
        variant, params, _ = _jit_variant(name, 8, 4096, dev)
        kernels = ("flash", "paged") if variant.use_softmax else ("flash",)
        for kernel in kernels:
            c = compile_variant(variant, params, kernel, 8)
            targets.append((f"{kernel}_attention", c.header_path()))
    jit.build_all(list(dict.fromkeys(targets)))


JIT_FLASH_SHAPES = {"prefill": (70, 70, True, -1),
                    "long": (300, 700, True, -1),
                    "qo_gt_kv": (90, 40, True, -1),
                    "split": (1, 3000, False, -1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(JIT_FLASH_SHAPES))
@pytest.mark.parametrize("name", JIT_VARIANTS)
def test_flash_kernel_runs_a_callers_variant(dev, jit_built, dtype, shape,
                                            name):
    """A caller's variant in the flash kernel's build for it against the
    plain version (the split case merges its key splits in the kernel's
    merge launch, which applies the output transform), and against the
    built-in variant's library where one computes the same function."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )

    qo, kv, causal, window = JIT_FLASH_SHAPES[shape]
    hq, hkv = (32, 8) if shape == "split" else (8, 2)
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn(n, h, 64, device=dev, generator=gen).to(dtype)
               for n, h in ((qo, hq), (kv, hkv), (kv, hkv)))
    if name == "soft_cap":
        q = q * 4
    variant, params, builtin = _jit_variant(name, hq, kv, dev)
    kw = dict(causal=causal, window_left=window, variant=variant,
              variant_params=params)
    before = flash_attention_dense.launches
    o, lse = flash_attention_dense(q, k, v, **kw)
    assert flash_attention_dense.launches == before + 1
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _check_flash(o, lse, ref_o, ref_lse, dtype)
    if builtin is not None:
        b_o, b_lse = flash_attention_dense(q, k, v, **{**kw,
                                                       "variant": builtin})
        _check_flash(o, lse, b_o, b_lse, dtype)


# (mode, tile_q, q dtype, cache): the wgmma prefill tiles, the swap-AB
# decode tiles, the f32 CUDA-core kernel, e4m3 and int8 caches
JIT_PAGED_PATHS = {
    "prefill_tiles": ("prefill", 64, torch.bfloat16, "model"),
    "decode_tiles": ("decode", None, torch.bfloat16, "model"),
    "f32": ("prefill", 16, torch.float32, "model"),
    "e4m3": ("prefill", 64, torch.bfloat16, "e4m3"),
    "e4m3_decode": ("decode", None, torch.bfloat16, "e4m3"),
    "int8": ("decode", None, torch.bfloat16, "int8"),
    "int8_f32": ("prefill", 16, torch.float32, "int8"),
}


@pytest.mark.parametrize("path", list(JIT_PAGED_PATHS))
@pytest.mark.parametrize("name", [n for n in JIT_VARIANTS if n != "sigmoid"])
def test_paged_kernel_runs_a_callers_variant(dev, jit_built, path, name):
    """A caller's variant in the paged kernel's build for it, on each of
    its three kernels and the 8-bit caches, against the plain version (the
    hooks see s * sm_scale * k_scale and the row's true head); the output
    transform is not applied, as in the TPU kernel."""
    mode, tile_q, qdt, kv = JIT_PAGED_PATHS[path]
    rng = np.random.default_rng(32)
    gen = torch.Generator(device=dev).manual_seed(32)
    ps, hq, hkv, d = 16, 8, 2, 64
    dp, pages, _ = _plan(mode, ps, hq, hkv, d, rng, tile_q)
    kc, vc = _paged_caches(dev, gen, "NHD", kv, qdt, pages, ps, hkv, d, d)
    q = torch.randn(hkv, dp.meta.bucket_rows, d, device=dev,
                    generator=gen).to(qdt)
    if name == "soft_cap":
        q = q * 4
    variant, params, _ = _jit_variant(name, hq, 4096, dev)
    _paged_check(dev, dp, kc, vc, q, hq, hkv, d, k_scale=0.7, v_scale=1.3,
                 variant=variant, variant_params=params)


def test_jit_builds_once(dev, monkeypatch):
    """A second call with the same variant loads no library and runs no
    nvcc; a variant differing in a closure constant has its own build."""
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.jit import core
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
    )
    from flashinfer_tpu_torch.ops.attention.variants import AttentionVariant

    def scaled(c):
        return AttentionVariant(
            name=f"x{c}", logits_transform=lambda p, s, qp, kp, h: s * c)

    q = torch.randn(20, 4, 64, device=dev)
    flash_attention_dense(q, q, q, variant=scaled(2.0))
    calls = []
    real = core.build_all
    monkeypatch.setattr(core, "build_all",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    o1, _ = flash_attention_dense(q, q, q, variant=scaled(2.0))
    assert calls == []
    o2, _ = flash_attention_dense(q, q, q, variant=scaled(3.0))
    assert len(calls) == 1 and not torch.equal(o1, o2)
    assert any(":" in n for n in jit.jit_registry.get_stats())


@pytest.mark.parametrize("case", ["ragged", "sink", "bsr", "bsr12",
                                  "variable"])
def test_surface_wrappers_on_the_card(dev, case):
    """The ragged, sink and block-sparse wrappers in bf16 on the card
    against their reference backend (the f32 oracle over the same bf16
    values): o to 2^-6 |ref| + 2^-8, as the flash kernel's bf16 check."""
    from flashinfer_tpu_torch.ops.attention import sparse

    rng = np.random.default_rng(len(case))
    gen = torch.Generator(device=dev).manual_seed(len(case))
    hq, hkv, d = 8, 2, 64

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    def both(make, plan, *run):
        outs = []
        for backend in ("auto", "reference"):
            w = make(backend)
            w.plan(*plan[0], **plan[1])
            outs.append(w.run(*run))
        return outs

    if case == "ragged":
        kv = np.asarray([300, 17, 129])
        qo = np.asarray([40, 17, 5])
        k, v = rand(int(kv.sum()), hkv, d), rand(int(kv.sum()), hkv, d)
        got, want = both(
            lambda b: attn_batch.BatchPrefillWithRaggedKVCacheWrapper(
                backend=b, device="cuda"),
            ((np.concatenate([[0], np.cumsum(qo)]),
              np.concatenate([[0], np.cumsum(kv)]), hq, hkv, d),
             dict(causal=True)), rand(int(qo.sum()), hq, d), k, v)
    elif case == "sink":
        kv = np.asarray([200, 31, 77, 5])
        npages = -(-kv // 16)
        indptr = np.concatenate([[0], np.cumsum(npages)])
        cache = (rand(int(indptr[-1]), hkv, 16, d),
                 rand(int(indptr[-1]), hkv, 16, d))
        sink = torch.randn(hq, device=dev, generator=gen)
        got, want = both(
            lambda b: attn_batch.BatchAttentionWithAttentionSinkWrapper(
                sink, backend=b, device="cuda"),
            ((np.arange(5), indptr, np.arange(indptr[-1]),
              (kv - 1) % 16 + 1, hq, hkv, d, 16), dict(window_left=31)),
            rand(4, hq, d), cache)
    elif case in ("bsr", "bsr12"):
        R, C = 16, 64 if case == "bsr" else 12
        mb, nb = 8, 8
        mask = rng.random((mb, nb)) < 0.4
        mask[:, 0] = True
        indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
        got, want = both(
            lambda b: sparse.BlockSparseAttentionWrapper(
                backend=b, device="cuda"),
            ((indptr, np.nonzero(mask)[1], R * mb, C * nb, R, C, hq, hkv, d),
             {}), rand(R * mb, hq, d), rand(C * nb, hkv, d),
            rand(C * nb, hkv, d))
    else:
        rows, cols = np.asarray([30, 64, 9]), np.asarray([40, 7, 100, 33])
        mask = np.asarray([[1, 0, 1, 0], [0, 1, 1, 1], [1, 1, 0, 1]], bool)
        got, want = both(
            lambda b: sparse.VariableBlockSparseAttentionWrapper(
                backend=b, device="cuda"),
            ((mask, rows, cols, hq, hkv, d), {}), rand(int(rows.sum()), hq, d),
            rand(int(cols.sum()), hkv, d), rand(int(cols.sum()), hkv, d))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 ** -6 * want.float().abs() + 2 ** -8).all()), \
        float(err.max())


@pytest.mark.parametrize("case", ["k96_n200_bf16", "per_channel_e4m3"])
def test_fused_moe_ragged_route_on_the_card(dev, case):
    """Calls the grouped-GEMM kernel cannot take (K 96 / N 200 in bf16;
    e4m3 weights with a scale a weight row) run the ragged_dot route on the
    card as on the CPU, and launch no grouped GEMM."""
    from flashinfer_tpu_torch.ops.fused_moe import fused_moe, route_tokens
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    gen = torch.Generator().manual_seed(6)
    m, e, top_k = 40, 8, 2
    hidden, inter = (96, 100) if case == "k96_n200_bf16" else (256, 128)
    x = torch.randn(m, hidden, generator=gen).bfloat16()
    w13 = torch.randn(e, 2 * inter, hidden, generator=gen) * 0.1
    w2 = torch.randn(e, hidden, inter, generator=gen) * 0.1
    kw = {}
    if case == "k96_n200_bf16":
        w13, w2 = w13.bfloat16(), w2.bfloat16()
    else:
        s13 = torch.rand(e, 2 * inter, 1, generator=gen) * 0.02 + 0.01
        s2 = torch.rand(e, hidden, 1, generator=gen) * 0.02 + 0.01
        w13 = (w13 / s13).to(torch.float8_e4m3fn)
        w2 = (w2 / s2).to(torch.float8_e4m3fn)
        kw = dict(w13_scale=s13, w2_scale=s2)
    ids, sc = route_tokens(torch.randn(m, e, generator=gen), top_k)
    want = fused_moe(x, w13, w2, ids, sc, out_dtype=torch.float32, **kw)
    before = grouped_gemm_padded.launches
    got = fused_moe(*(t.to(dev) for t in (x, w13, w2, ids, sc)),
                    out_dtype=torch.float32,
                    **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert grouped_gemm_padded.launches == before
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))


@pytest.mark.parametrize("filt", ["none", "top_k", "top_p", "min_p",
                                  "top_k_top_p_joint", "top_k_top_p_seq"])
def test_sampler_kernel_matches_plain(dev, filt):
    gen = torch.Generator(device=dev).manual_seed(0)
    probs = torch.softmax(
        torch.randn(6, 5000, device=dev, generator=gen) * 3, -1)
    k = torch.randint(1, 100, (6, 1), device=dev, dtype=torch.int32,
                      generator=gen)
    p = torch.rand(6, 1, device=dev, generator=gen) * 0.6 + 0.3
    if filt == "min_p":
        p = p * 0.2
    for seed in (1, 2**31 - 2):
        before = family_call.launches
        got = family_call(probs, seed, k, p, filt=filt, out_mode="sample")
        assert family_call.launches == before + 1
        want = family_plain(probs, seed, k, p, filt=filt, out_mode="sample")
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    for mode in ("renorm",):
        got = family_call(probs, 0, k, p, filt=filt, out_mode=mode)
        want = family_plain(probs, 0, k, p, filt=filt, out_mode=mode)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_sampler_kernel_mask_logits(dev):
    x = torch.randn(4, 3000, device=dev)
    k = torch.tensor([[1], [50], [2999], [3000]], device=dev,
                     dtype=torch.int32)
    got = family_call(x, 0, k, 1.0, filt="top_k", out_mode="mask_logits")
    want = family_plain(x, 0, k, torch.ones(4, 1, device=dev), filt="top_k",
                        out_mode="mask_logits")
    torch.testing.assert_close(got, want, atol=0, rtol=0)


SAMPLER_FILTS = ["none", "top_k", "top_p", "min_p", "top_k_top_p_joint",
                 "top_k_top_p_seq"]
# beyond the cluster route's shared memory at 8 CTAs a row
SAMPLER_STREAM_VOCAB = 500_000


def _sampler_rows(dev, batch, vocab, seed, filt="top_k"):
    """Peaked probability rows with a uniform row (all ties) and a one-hot
    row; k cycles over 1, 40, V - 1, V, V + 5 and p over 0.9, 1.0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    probs = torch.softmax(
        torch.randn(batch, vocab, device=dev, generator=gen) * 4, -1)
    if batch > 1:
        probs[1] = 1.0 / vocab
    if batch > 2:
        probs[2] = 0.0
        probs[2, vocab // 3] = 1.0
    ks = [1, 40, vocab - 1, vocab, vocab + 5]
    k = torch.tensor([[ks[i % 5]] for i in range(batch)], dtype=torch.int32,
                     device=dev)
    p = torch.tensor([[(0.9, 1.0)[i % 2]] for i in range(batch)], device=dev)
    if filt == "min_p":
        p = p * 0.2
    return probs, k, p


def _sampler_check(probs, k, p, filt, seeds=(1, -1)):
    for seed in seeds:
        before = family_call.launches
        got = family_call(probs, seed, k, p, filt=filt, out_mode="sample")
        assert family_call.launches == before + 1
        want = family_plain(probs, seed, k, p, filt=filt, out_mode="sample")
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = family_call(probs, 0, k, p, filt=filt, out_mode="renorm")
    want = family_plain(probs, 0, k, p, filt=filt, out_mode="renorm")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("filt", SAMPLER_FILTS)
@pytest.mark.parametrize("vocab", [5000, 32000, 102400, 128256, 151937])
@pytest.mark.parametrize("batch", [1, 3, 8, 17])
def test_sampler_cluster_route_matches_plain(dev, batch, vocab, filt):
    """The cluster route at the served vocabularies and an odd one, one
    cluster a row (17 rows: more clusters than the card runs at once)."""
    assert sampler_route(vocab)["route"] == "cluster"
    probs, k, p = _sampler_rows(dev, batch, vocab, batch * 7 + vocab, filt)
    _sampler_check(probs, k, p, filt)


@pytest.mark.parametrize("filt", SAMPLER_FILTS)
def test_sampler_stream_route_matches_plain(dev, filt):
    """Rows beyond the cluster's shared memory take the streaming route."""
    assert sampler_route(SAMPLER_STREAM_VOCAB)["route"] == "stream"
    probs, k, p = _sampler_rows(dev, 3, SAMPLER_STREAM_VOCAB, 11, filt)
    _sampler_check(probs, k, p, filt)


@pytest.mark.parametrize("vocab", [3000, 128256, 151937,
                                   SAMPLER_STREAM_VOCAB])
def test_sampler_mask_logits_both_routes(dev, vocab):
    gen = torch.Generator(device=dev).manual_seed(vocab)
    x = torch.randn(5, vocab, device=dev, generator=gen) * 3
    x[1] = 0.5  # all ties
    k = torch.tensor([[1], [40], [vocab - 1], [vocab], [vocab + 5]],
                     device=dev, dtype=torch.int32)
    got = family_call(x, 0, k, 1.0, filt="top_k", out_mode="mask_logits")
    want = family_plain(x, 0, k, torch.ones(5, 1, device=dev), filt="top_k",
                        out_mode="mask_logits")
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("vocab", [128256, SAMPLER_STREAM_VOCAB])
@pytest.mark.parametrize("seed", [-1, 2**31 - 1, 2**32 - 1])
def test_sampler_seed_takes_all_32_bits(dev, vocab, seed):
    """The seed's 32 bits reach the noise as they are (2**32 - 1 is -1),
    on both routes, as in the plain version and JAX's kernel."""
    gen = torch.Generator(device=dev).manual_seed(2)
    probs = torch.softmax(torch.randn(4, vocab, device=dev, generator=gen),
                          -1)
    for filt in ("none", "top_k_top_p_seq"):
        got = family_call(probs, seed, 40, 0.9, filt=filt,
                          out_mode="sample")
        want = family_plain(probs, seed, torch.full((4, 1), 40, device=dev),
                            torch.full((4, 1), 0.9, device=dev), filt=filt,
                            out_mode="sample")
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        assert torch.equal(got, family_call(probs, seed - 2**32 if seed
                                            >= 2**31 else seed, 40, 0.9,
                                            filt=filt, out_mode="sample"))


@pytest.mark.parametrize("vocab", [128256, SAMPLER_STREAM_VOCAB])
def test_sampler_seed_from_device_memory_in_a_cuda_graph(dev, vocab):
    """A draw captured with a device seed replays with the seed that memory
    holds at replay: the plain version's tokens for the new seed."""
    gen = torch.Generator(device=dev).manual_seed(4)
    probs = torch.softmax(
        torch.randn(8, vocab, device=dev, generator=gen) * 4, -1)
    k = torch.full((8, 1), 40, dtype=torch.int32, device=dev)
    p = torch.full((8, 1), 0.9, device=dev)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    kw = dict(filt="top_k_top_p_seq", out_mode="sample")
    family_call(probs, seed, k, p, **kw)  # builds and loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        tok = family_call(probs, seed, k, p, **kw)
    for new in (123, -7, 2**31 - 1):
        seed.fill_(new)
        g.replay()
        torch.testing.assert_close(tok, family_plain(probs, new, k, p, **kw),
                                   atol=0, rtol=0)


def test_sampler_gathers_the_candidates_of_a_peaked_row(dev):
    """A peaked row's top-k search gathers the entries above its lo into
    one list (at least its 40 entries) after a few cluster passes and
    finishes in warp 0 of each CTA alone; a uniform row (all ties) keeps
    every entry above lo and never gathers."""
    probs, k, p = _sampler_rows(dev, 2, 128256, 5)
    k[:] = 40
    p[:] = 0.9
    stats = sampling_mod.sampler_stats(probs, k, p, filt="top_k_top_p_seq",
                                       out_mode="sample")
    assert stats[0, 2] >= 40 and stats[0, 0] < 19 and stats[0, 1] > 0
    assert stats[1, 2] == -1 and stats[1, 1] == 0


def test_sampler_route_by_vocabulary(dev):
    """The C entry's route: a cluster of 8 CTAs, 4 bisection steps a pass,
    while a row's slices fit in shared memory (at most 200 KB a CTA), else
    the streaming route."""
    for vocab in (5000, 102400, 128256, 151937, 409600):
        r = sampler_route(vocab)
        assert (r["route"], r["cluster"], r["levels"]) == ("cluster", 8, 4)
        assert r["slice"] * 8 >= vocab and r["max_active_clusters"] >= 1
    r = sampler_route(409601)
    assert (r["route"], r["cluster"], r["slice"]) == ("stream", 0, 0)


def _plateau_rows(dev, batch, vocab, seed, filt):
    """_sampler_rows with 2048 entries of each row tied at its top: more
    than the top-k search gathers, so it stays on cluster passes to its
    end."""
    probs, k, p = _sampler_rows(dev, batch, vocab, seed, filt)
    top = probs.amax(-1, keepdim=True)
    idx = torch.randperm(vocab, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))[:2048]
    probs[:, idx] = top
    return probs / probs.sum(-1, keepdim=True), k, p


@pytest.mark.parametrize("rows", ["peaked", "plateau"])
def test_sampler_cluster_shapes_agree(dev, rows):
    """Both ends of a top-k search on the cluster route draw the plain
    version's tokens and masks: peaked rows gather their candidates into
    one warp's list, rows with 2048 entries tied at the top keep the search
    on cluster passes to its end."""
    make = _sampler_rows if rows == "peaked" else _plateau_rows
    for filt in ("top_k_top_p_seq", "top_k_top_p_joint"):
        probs, k, p = make(dev, 5, 128256, 8, filt)
        k[0] = 40
        stats = sampling_mod.sampler_stats(probs, k, p, filt=filt,
                                           out_mode="sample")
        assert (int(stats[0, 2]) >= 40) == (rows == "peaked")
        _sampler_check(probs, k, p, filt)
    probs, _, _ = make(dev, 5, 32000, 1, "top_k")
    x = torch.log(probs + 1e-30)
    k = torch.tensor([[1], [40], [31999], [32000], [32005]], device=dev,
                     dtype=torch.int32)
    torch.testing.assert_close(
        family_call(x, 0, k, 1.0, filt="top_k", out_mode="mask_logits"),
        family_plain(x, 0, k, torch.ones(5, 1, device=dev), filt="top_k",
                     out_mode="mask_logits"), atol=0, rtol=0)


NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7, torch.float16: 2**-10}


@pytest.mark.parametrize("dtype", list(NORM_TOL))
@pytest.mark.parametrize("rows", [1, 37, 4096])
@pytest.mark.parametrize("hidden", [96, 1000, 1001, 4096])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
def test_rmsnorm_kernel_matches_plain(dev, dtype, rows, hidden, fused,
                                      strided):
    """Both modes, one launch each (counted in ``rmsnorm.launches``): the
    fused residual bit for bit, out to one rounding step of the dtype.
    Hidden 1001 (not a multiple of the 16-byte vector) and ``strided`` (x
    and the residual are views of rows of hidden + 1 values: a row stride
    that is not 16-byte aligned) take the scalar path; ``strided`` also
    takes every second value of a weight twice as long, which the wrapper
    copies just before the launch. In every case the launch right before
    the norm writes w, which the kernel must wait for."""
    gen = torch.Generator(device=dev).manual_seed(rows * hidden)

    def draw():
        t = torch.randn(rows, hidden + strided, device=dev, generator=gen)
        return t.to(dtype)[:, :hidden]

    x, res = draw(), draw()
    w = torch.randn(hidden * (1 + strided), device=dev, generator=gen).to(
        dtype)[::1 + strided]
    before = rmsnorm.launches
    if fused:
        got, got_res = fused_add_rmsnorm(x, res, w, 1e-5, weight_bias=0.5)
        want, want_res = fused_add_rmsnorm_plain(x, res, w, 1e-5,
                                                 weight_bias=0.5)
        assert got_res.dtype == dtype
        assert torch.equal(got_res, want_res)
    else:
        got = rmsnorm(x, w, 1e-5, weight_bias=0.5)
        want = rmsnorm_plain(x, w, 1e-5, weight_bias=0.5)
    assert rmsnorm.launches == before + 1
    assert got.dtype == dtype
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("hidden", [4096, 1000])
def test_fused_add_rmsnorm_in_a_cuda_graph(dev, hidden):
    """The fused norm captured in a CUDA graph behind a matmul that writes
    its x (as the serving step orders them; the norm may start before the
    matmul ends and waits for it), replayed on new inputs, gives the bits
    of an eager launch on the matmul's output."""
    gen = torch.Generator(device=dev).manual_seed(hidden)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(
            torch.bfloat16)

    a, res = randn(8, hidden), randn(8, hidden)
    wmat = randn(hidden, hidden) / math.sqrt(hidden)
    w = randn(hidden)

    def step():
        y = a @ wmat
        return (y,) + fused_add_rmsnorm(y, res, w, 1e-5)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, out, new_res = step()
    for _ in range(2):
        a.copy_(randn(8, hidden))
        res.copy_(randn(8, hidden))
        graph.replay()
        torch.cuda.synchronize()
        want, want_res = fused_add_rmsnorm(y, res, w, 1e-5)
        assert torch.equal(new_res, want_res)
        assert torch.equal(out, want)


def test_fused_add_rmsnorm_refuses_mixed_dtypes(dev):
    x = torch.ones(2, 64, device=dev, dtype=torch.bfloat16)
    w = torch.ones(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_add_rmsnorm(x, x.float(), w)
    with pytest.raises(TypeError):
        rmsnorm(x, w.float())


def _mla_case(dev, mode, qdt, kv, heads, d_ckv, d_kpe, kpe_width, rng):
    """A planned MLA batch on the card: (packed q_ckv, q_pe, caches,
    kv_indices, plan, meta)."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )

    ps = 16
    if mode == "decode":
        kv_lens = rng.integers(1, 300, 5)
        qo = np.ones(5, np.int64)
    else:
        qo = rng.integers(20, 90, 3)
        kv_lens = qo + rng.integers(0, 60, 3)
    npages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1]) + 3
    indices = rng.permutation(pages)[: int(indptr[-1])]
    w = BatchMLAPagedAttentionWrapper(device="cuda")
    w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr, indices, kv_lens,
           heads, d_ckv, d_kpe, ps, causal=mode != "decode",
           kv_chunk_size=64)
    dp = w.device_plan
    caches = []
    for width in (d_ckv, kpe_width):
        c = torch.randn(pages, ps, width, device=dev)
        if kv == "int8":
            c = (c * 20).round().clamp(-127, 127).to(torch.int8)
        elif kv == "e4m3":
            c = c.to(torch.float8_e4m3fn)
        else:
            c = c.to(qdt)
        caches.append(c)
    rows = dp.meta.bucket_rows
    q_ckv = torch.randn(rows, d_ckv, device=dev).to(qdt)
    q_pe = torch.randn(rows, d_kpe, device=dev).to(qdt)
    return (q_ckv, q_pe, caches[0], caches[1], dp.segment("kv_indices"),
            dp.segment("plan"), dp.meta)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("heads,d_ckv,d_kpe,kpe_width",
                         [(16, 512, 64, 64), (4, 64, 32, 128)])
def test_mla_kernel_matches_plain(dev, qdt, kv, mode, heads, d_ckv, d_kpe,
                                  kpe_width):
    from flashinfer_tpu_torch.ops.attention.mla import (
        mla_paged_plain,
        mla_paged_run,
    )

    rng = np.random.default_rng(3)
    *args, m = _mla_case(dev, mode, qdt, kv, heads, d_ckv, d_kpe, kpe_width,
                         rng)
    # an int8 cache holds values x 20: its dequant scale folds into both
    deq = 0.05 if kv == "int8" else 1.0
    kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
              sm_scale=0.7 * deq / (d_ckv + d_kpe) ** 0.5, v_scale=1.3 * deq)
    before = mla_paged_run.launches
    o, lse = mla_paged_run(*args, **kw)
    assert mla_paged_run.launches == before + 1
    ref_o, ref_lse = mla_paged_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if (qdt == torch.float32 and kv == "model") else 2e-2
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


# DeepSeek's MLA widths, on the tensor-core routes for bf16 q:
# (q dtype, cache kind) of each case
MLA_KINDS = {"bf16": (torch.bfloat16, "model"),
             "e4m3": (torch.bfloat16, "e4m3"),
             "int8": (torch.bfloat16, "int8"),
             "f32": (torch.float32, "model"),
             "f32_int8": (torch.float32, "int8")}


def _mla_tc_case(dev, gen, qdt, kv, tile_q, chunk, kpe_width, qo, kv_lens,
                 causal):
    """A planned 16-head MLA batch (d_ckv 512, d_kpe 64, pages of 16) drawn
    from ``gen``: (packed q_ckv, q_pe, ckv, kpe, kv_indices, plan, meta)."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )

    ps, heads = 16, 16
    qo, kv_lens = np.asarray(qo), np.asarray(kv_lens)
    npages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1]) + 3
    indices = np.random.default_rng(chunk).permutation(pages)[
        : int(indptr[-1])]
    w = BatchMLAPagedAttentionWrapper(device="cuda", tile_q=tile_q)
    w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr, indices, kv_lens,
           heads, 512, 64, ps, causal=causal, kv_chunk_size=chunk)
    dp = w.device_plan
    caches = []
    for width in (512, kpe_width):
        c = torch.randn(pages, ps, width, device=dev, generator=gen)
        if kv == "int8":
            c = (c * 20).round().clamp(-127, 127).to(torch.int8)
        elif kv == "e4m3":
            c = c.to(torch.float8_e4m3fn)
        else:
            c = c.to(qdt)
        caches.append(c)
    rows = dp.meta.bucket_rows
    q_ckv = torch.randn(rows, 512, device=dev, generator=gen).to(qdt)
    q_pe = torch.randn(rows, 64, device=dev, generator=gen).to(qdt)
    return (q_ckv, q_pe, caches[0], caches[1], dp.segment("kv_indices"),
            dp.segment("plan"), dp.meta)


@pytest.mark.parametrize("kind", list(MLA_KINDS))
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("tile_q", [8, 16, 32, 64, 128])
def test_mla_kernel_routes_match_plain(dev, kind, chunk, tile_q):
    """Every route at DeepSeek's widths: the swap-AB decode tiles (8, 16, 32
    rows) and the 64-row tiles (64, 128) for bf16 q on bf16, e4m3 and int8
    caches, the CUDA cores for f32 q; KV chunks of 16, 64 and 256 keys over
    spans that end inside a page and inside a 64-key tile, padding items
    (every plan but tile_q 128 / chunk 256 has some), causal rows that see
    no key (a request of fewer keys than tokens), and a kpe cache read
    through a row stride of 128 (chunk 64)."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        mla_paged_plain,
        mla_paged_run,
        mla_route,
    )

    qdt, kv = MLA_KINDS[kind]
    gen = torch.Generator(device=dev).manual_seed(tile_q * 1000 + chunk)
    kpe_width = 128 if chunk == 64 else 64
    *args, m = _mla_tc_case(dev, gen, qdt, kv, tile_q, chunk, kpe_width,
                            qo=[1, 3, 40, 1], kv_lens=[77, 300, 30, 129],
                            causal=True)
    assert m.tile_q == tile_q
    want = ("cuda_cores" if qdt == torch.float32
            else "decode" if tile_q <= 32 else "prefill")
    assert mla_route(qdt, args[2].dtype, tile_q, 512, 64, 16) == want
    # an int8 cache holds values x 20: its dequant scale folds into both
    deq = INT8_UNIT if kv == "int8" else 1.0
    kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
              sm_scale=0.7 * deq / 576 ** 0.5, v_scale=1.3 * deq)
    before = mla_paged_run.launches
    o, lse = mla_paged_run(*args, **kw)
    assert mla_paged_run.launches == before + 1
    ref_o, ref_lse = mla_paged_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if (qdt == torch.float32 and kv == "model") else 2e-2
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_mla_served_decode_in_a_cuda_graph(dev):
    """The decode the DeepSeek path serves (8 requests of 33-160 keys, 16
    heads, KV chunk 64, tile_q 16, bf16) captured in a CUDA graph: each
    replay on new q (written in place) matches the plain version."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        mla_paged_plain,
        mla_paged_run,
    )

    gen = torch.Generator(device=dev).manual_seed(14)
    kv_lens = np.random.default_rng(14).integers(33, 161, 8)
    *args, m = _mla_tc_case(dev, gen, torch.bfloat16, "model", None, 64, 64,
                            qo=np.ones(8, np.int64), kv_lens=kv_lens,
                            causal=False)
    assert m.tile_q == 16
    q_ckv, q_pe = args[0], args[1]
    kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=False,
              sm_scale=576 ** -0.5)
    mla_paged_run(*args, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = mla_paged_run(*args, **kw)
    for _ in range(3):
        q_ckv.copy_(torch.randn(q_ckv.shape, device=dev, generator=gen))
        q_pe.copy_(torch.randn(q_pe.shape, device=dev, generator=gen))
        graph.replay()
        ref_o, ref_lse = mla_paged_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), ref_o.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _gg_case(dev, wdt, tm, k, n, nk, rng):
    from flashinfer_tpu_torch.ops.gemm_grouped import make_group_layout

    e = 6
    gs = torch.from_numpy(rng.integers(0, 3 * tm, e)).to(dev)
    gs[1] = 0  # an empty expert
    lay = make_group_layout(gs, int(gs.sum()), tm)
    xdt = torch.float32 if wdt == torch.float32 else torch.bfloat16
    x = torch.randn(lay.m_pad, k, device=dev)
    x = torch.where(lay.src_valid[:, None], x, 0).to(xdt)
    w = torch.randn((e, n, k) if nk else (e, k, n), device=dev) * 0.1
    if wdt == torch.float8_e4m3fn:
        w = (w * 10).to(wdt)
    else:
        w = w.to(wdt)
    scales = torch.rand(e, device=dev) + 0.5
    return x, w, lay.expert_of_tile, scales


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn,
                                 torch.float32])
@pytest.mark.parametrize("tm", [16, 32, 64, 128])
@pytest.mark.parametrize("nk", [False, True])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_gemm_kernel_matches_plain(dev, wdt, tm, nk, out):
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
    )

    rng = np.random.default_rng(tm)
    k, n = (256, 384) if wdt != torch.float32 else (72, 40)
    x, w, eot, sc = _gg_case(dev, wdt, tm, k, n, nk, rng)
    before = grouped_gemm_padded.launches
    got = grouped_gemm_padded(x, w, eot, sc, out_dtype=out, rhs_nk=nk)
    assert grouped_gemm_padded.launches == before + 1
    want = grouped_gemm_padded_plain(x, w, eot, sc, out_dtype=out,
                                     rhs_nk=nk)
    torch.cuda.synchronize()
    rms = float(want.float().pow(2).mean().sqrt())
    rtol = 2 ** -7 if out == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 * rms)
    pad = eot.long().repeat_interleave(tm) < 0
    assert not got[pad].any()  # -1 tiles are zeros


def _gg_check(got, want, eot, tm, out):
    rms = float(want.float().pow(2).mean().sqrt())
    rtol = 2 ** -7 if out == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 * rms)
    pad = eot.long().repeat_interleave(tm) < 0
    assert not got[pad].any()  # -1 tiles are zeros


def _gg_weights(dev, wdt, e, k, n, nk, gen):
    w = torch.randn((e, n, k) if nk else (e, k, n), device=dev,
                    generator=gen) * k ** -0.5
    return (w * 64).to(wdt) if wdt == torch.float8_e4m3fn else w.to(wdt)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("nk", [False, True])
@pytest.mark.parametrize("tm", [16, 128])
@pytest.mark.parametrize("k,n", [(96, 384), (160, 400)])
def test_grouped_gemm_ragged_edges(dev, wdt, nk, tm, k, n):
    """K not a multiple of the ring's 64-deep stage (the maps fill zeros
    past K), and a ragged last column tile (zeros past N, a masked store):
    N = 384 against tm 128's 256-column tiles, N = 400 against both
    widths (128 columns at tm 16)."""
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
    )

    rng = np.random.default_rng(k + n + tm)
    x, _, eot, sc = _gg_case(dev, torch.bfloat16, tm, k, n, nk, rng)
    w = _gg_weights(dev, wdt, 6, k, n, nk,
                    torch.Generator(device=dev).manual_seed(k + n))
    for out in (torch.bfloat16, torch.float32):
        got = grouped_gemm_padded(x, w, eot, sc, out_dtype=out, rhs_nk=nk)
        want = grouped_gemm_padded_plain(x, w, eot, sc, out_dtype=out,
                                         rhs_nk=nk)
        torch.cuda.synchronize()
        _gg_check(got, want, eot, tm, out)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("tm", [16, 64, 128])
def test_grouped_gemm_expert_over_many_tiles(dev, wdt, tm):
    """One expert's rows span five full m-tiles and part of a sixth, beside
    experts of a tile or none."""
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
        make_group_layout,
    )

    gen = torch.Generator(device=dev).manual_seed(tm)
    gs = torch.tensor([3, 5 * tm + 3, 0, tm], device=dev)
    lay = make_group_layout(gs, int(gs.sum()), tm)
    k, n = 256, 256
    x = torch.randn(lay.m_pad, k, device=dev, generator=gen)
    x = torch.where(lay.src_valid[:, None], x, 0).bfloat16()
    w = _gg_weights(dev, wdt, 4, k, n, True, gen)
    sc = torch.rand(4, device=dev, generator=gen) + 0.5
    got = grouped_gemm_padded(x, w, lay.expert_of_tile, sc,
                              out_dtype=torch.float32, rhs_nk=True)
    want = grouped_gemm_padded_plain(x, w, lay.expert_of_tile, sc,
                                     out_dtype=torch.float32, rhs_nk=True)
    torch.cuda.synchronize()
    assert int((lay.expert_of_tile == 1).sum()) == 6
    _gg_check(got, want, lay.expert_of_tile, tm, torch.float32)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_gemm_all_tiles_unused(dev, wdt, out):
    """Every tile -1: the output is zeros over memory that held garbage."""
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    tm, k, n = 16, 128, 256
    x = torch.randn(8 * tm, k, device=dev).bfloat16()
    w = torch.randn(3, n, k, device=dev).to(wdt)
    eot = torch.full((8,), -1, dtype=torch.int32, device=dev)
    torch.empty(8 * tm, n, dtype=out, device=dev).fill_(7.0)  # dirty pool
    got = grouped_gemm_padded(x, w, eot, None, out_dtype=out, rhs_nk=True)
    torch.cuda.synchronize()
    assert got.shape == (8 * tm, n) and not got.any()


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("gemm", ["gate_up", "down"])
def test_grouped_gemm_v2_lite_decode_routing(dev, wdt, gemm):
    """chip_smoke's V2-Lite decode case at full width: 8 tokens routed
    top-6 of 64 experts (48 rows, tm 16), 2048 -> 2816 and 1408 -> 2048,
    weights in the models' [E, N, K] layout."""
    from flashinfer_tpu_torch.ops.fused_moe import (
        RoutingMethodType,
        _permute_by_expert,
        route_tokens,
        select_moe_tm,
    )
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
        make_group_layout,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    m, e, top_k = 8, 64, 6
    ids, _ = route_tokens(torch.randn(m, e, device=dev, generator=gen), top_k,
                          RoutingMethodType.DeepSeekV3, n_group=1,
                          topk_group=1)
    _, group_sizes = _permute_by_expert(ids, e)
    tm = select_moe_tm(m * top_k, e)
    assert tm == 16
    lay = make_group_layout(group_sizes, m * top_k, tm)
    k, n, out = ((2048, 2816, torch.bfloat16) if gemm == "gate_up"
                 else (1408, 2048, torch.float32))
    x = torch.randn(lay.m_pad, k, device=dev, generator=gen)
    x = torch.where(lay.src_valid[:, None], x, 0).bfloat16()
    w = _gg_weights(dev, wdt, e, k, n, True, gen)
    sc = (torch.full((e,), 1 / 64, device=dev)
          if wdt == torch.float8_e4m3fn else None)
    got = grouped_gemm_padded(x, w, lay.expert_of_tile, sc, out_dtype=out,
                              rhs_nk=True)
    want = grouped_gemm_padded_plain(x, w, lay.expert_of_tile, sc,
                                     out_dtype=out, rhs_nk=True)
    torch.cuda.synchronize()
    _gg_check(got, want, lay.expert_of_tile, tm, out)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
def test_fused_moe_in_a_cuda_graph(dev, wdt):
    """fused_moe captured in a CUDA graph and replayed on a second routing
    gives what an eager call on that routing gives: no step of the
    pipeline reads back to the host, and the kernel's tensor maps are
    recorded by value."""
    from flashinfer_tpu_torch.ops.fused_moe import fused_moe, route_tokens

    gen = torch.Generator(device=dev).manual_seed(5)
    m, e, hidden, inter, top_k = 24, 8, 256, 128, 2
    x = torch.randn(m, hidden, device=dev, generator=gen).bfloat16()
    w13 = _gg_weights(dev, wdt, e, hidden, 2 * inter, True, gen)
    w2 = _gg_weights(dev, wdt, e, inter, hidden, True, gen)
    s13 = torch.rand(e, device=dev, generator=gen) + 0.5
    s2 = torch.rand(e, device=dev, generator=gen) + 0.5
    routes = [route_tokens(torch.randn(m, e, device=dev, generator=gen),
                           top_k) for _ in range(2)]
    ids, sc = (t.clone() for t in routes[0])

    def call():
        return fused_moe(x, w13, w2, ids, sc, w13_scale=s13, w2_scale=s2,
                         out_dtype=torch.float32)

    call()  # builds and loads the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = call()
    ids.copy_(routes[1][0])
    sc.copy_(routes[1][1])
    g.replay()
    want = call()
    torch.cuda.synchronize()
    assert not torch.equal(routes[0][0], routes[1][0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn])
def test_fused_moe_on_the_card_matches_cpu(dev, wdt):
    from flashinfer_tpu_torch.ops.fused_moe import fused_moe, route_tokens

    gen = torch.Generator().manual_seed(4)
    m, e, hidden, inter, top_k = 40, 8, 256, 128, 3
    x = torch.randn(m, hidden, generator=gen).bfloat16()
    w13 = (torch.randn(e, 2 * inter, hidden, generator=gen) * 0.1).to(wdt)
    w2 = (torch.randn(e, hidden, inter, generator=gen) * 0.1).to(wdt)
    ids, sc = route_tokens(torch.randn(m, e, generator=gen), top_k)
    want = fused_moe(x, w13, w2, ids, sc, out_dtype=torch.float32)
    got = fused_moe(*(t.to(dev) for t in (x, w13, w2, ids, sc)),
                    out_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))


@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_tiny_engine_on_the_card_matches_cpu(dev, kv_dtype, layout):
    """Greedy tokens of the f32 tiny engine on the card (every kernel on)
    equal those of the CPU engine (every plain version)."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    mc = LlamaConfig.tiny()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist() for n in (9, 30, 4)]
    outs = []
    params = None
    for device in ("cpu", "cuda"):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, kv_dtype=kv_dtype,
                           kv_scale=0.3, kv_layout=layout, device=device)
        if params is None:
            eng = LlamaServingEngine(cfg, seed=0)
            params = eng.params
        else:
            eng = LlamaServingEngine(cfg, params=params)
        reqs = [eng.add_request(p, 6) for p in prompts]
        eng.run_to_completion(max_steps=100)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def _bf16_engine_run(prompts, n_new, **kw):
    """The bf16 tiny Llama engine on the card (tensor-core paged kernel),
    random weights from the engine's seeded CUDA generator: (outputs,
    engine, paged-attention and rmsnorm launches of the run)."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    cfg = EngineConfig(model=LlamaConfig.tiny(torch.bfloat16), page_size=8,
                       **{**dict(max_batch=4, num_pages=256,
                                 max_seq_len=128), **kw})
    eng = LlamaServingEngine(cfg, seed=0)
    paged0, norm0 = batch_paged_attention_run.launches, rmsnorm.launches
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion(max_steps=500)
    assert all(r.done for r in reqs)
    return ([r.output for r in reqs], eng,
            (batch_paged_attention_run.launches - paged0,
             rmsnorm.launches - norm0))


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_graphed_decode_matches_eager(dev, greedy, kv_dtype, layout):
    """Five requests on four slots (idle slots, admission between steps):
    the decode step replayed from CUDA graphs emits the eager step's
    tokens, bit for bit, sampled ones too (the same seeds). Each capture's
    warm-up runs one eager step, so the graphed run launches one step's
    kernels more per capture."""
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 30, 4, 17, 12)]
    kw = dict(greedy=greedy, kv_dtype=kv_dtype, kv_scale=0.3,
              kv_layout=layout)
    want, eager, (paged_e, norm_e) = _bf16_engine_run(
        prompts, 10, cuda_graphs=False, **kw)
    got, eng, (paged_g, norm_g) = _bf16_engine_run(prompts, 10, **kw)
    assert got == want
    assert eager.graphs.captures == 0 and eng.graphs.captures >= 1
    layers = eng.cfg.model.num_layers
    assert paged_g == paged_e + layers * eng.graphs.captures
    assert norm_g == norm_e + (2 * layers + 1) * eng.graphs.captures


def test_graph_recaptured_when_the_plan_meta_changes(dev):
    """A 505-token prompt crosses the 512-token KV chunk while decoding:
    the plan's split bucket grows, a second graph is captured, and the
    tokens still equal the eager step's."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, n).tolist() for n in (505, 30)]
    kw = dict(greedy=True, max_seq_len=1024)
    want, _, _ = _bf16_engine_run(prompts, 12, cuda_graphs=False, **kw)
    got, eng, _ = _bf16_engine_run(prompts, 12, **kw)
    assert got == want
    assert eng.graphs.captures >= 2


@pytest.mark.parametrize("greedy", [True, False])
def test_graphed_window_matches_graphed_steps(dev, greedy):
    """Window 4 (four replays a window, tokens fed back on the card, one
    read back) against single graphed steps: the same tokens, the seeds
    drawn in the same order."""
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 30, 4, 17)]
    want, _, _ = _bf16_engine_run(prompts, 13, greedy=greedy)
    got, eng, _ = _bf16_engine_run(prompts, 13, greedy=greedy,
                                   decode_window=4)
    assert got == want
    assert eng.graphs.captures >= 1 and eng.decode_steps == 12


def test_failed_capture_raises(dev):
    """A step that fails while it is captured raises out of the engine's
    step, and the engine does not run the step eagerly instead."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    eng = LlamaServingEngine(EngineConfig(
        model=LlamaConfig.tiny(torch.bfloat16), max_batch=2, num_pages=64,
        page_size=8, max_seq_len=64, greedy=True), seed=0)
    step, calls = eng._decode_body, []

    def failing(buf, key):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("step refused under capture")
        return step(buf, key)

    eng._decode_body = failing
    req = eng.add_request([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="refused under capture"):
        eng.step()
    assert calls == [False, True]  # the warm-up, then the capture
    assert eng.graphs.captures == 0 and req.output and len(req.output) == 1


def _verify_plan(dev, layout, kv_lens, spec_tokens=3, hq=32, hkv=8, d=128,
                 ps=16, chunk=512):
    """The spec engine's verify plan (``_spec_decode``) at Llama-3-8B heads:
    G + 1 causal rows a request at the end of its keys, a trailing dummy
    request for the pad rows, the worst-case work capacity. Returns (plan,
    pages)."""
    from flashinfer_tpu_torch.utils import next_power_of_2

    rows, batch = spec_tokens + 1, len(kv_lens)
    kv = np.asarray(kv_lens, np.int64)
    npages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1])
    indices = np.random.default_rng(30).permutation(pages)
    bucket = next_power_of_2(max(batch * rows, 8))
    w = attn_batch.BatchPrefillWithPagedKVCacheWrapper(kv_layout=layout,
                                                       device=dev)
    w.plan(np.concatenate([np.arange(batch + 1) * rows, [bucket]]),
           np.concatenate([indptr, [indptr[-1]]]), indices,
           np.concatenate([((kv - 1) % ps) + 1, [0]]), hq, hkv, d, ps,
           causal=True, kv_chunk_size=chunk,
           kv_len_arr=np.concatenate([kv, [0]]),
           work_capacity=next_power_of_2(batch * 4))
    return w.device_plan, pages


@pytest.mark.parametrize("kv", ["model", "e4m3", "int8"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_paged_kernel_at_the_verify_plan(dev, kv, layout):
    """The verify rows of Llama-3-8B (32 q heads on 8 kv heads, head_dim
    128): 8 requests of 4 causal rows (16 packed rows, the swap-AB decode
    tiles with a causal edge), one across the 512-key chunk (split KV)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    lens = [85, 117, 300, 513, 64, 200, 544, 97]
    dp, pages = _verify_plan(dev, layout, lens)
    assert dp.meta.tile_q == 16 and dp.meta.causal and dp.meta.max_splits > 1
    kc, vc = _paged_caches(dev, gen, layout, kv, torch.bfloat16, pages, 16,
                           8, 128, 128)
    q = torch.randn(8, dp.meta.bucket_rows, 128, device=dev,
                    generator=gen).bfloat16()
    _paged_check(dev, dp, kc, vc, q, 32, 8, 128, k_scale=0.7, v_scale=1.3,
                 kv_layout=TensorLayout[layout])


def _spec_engine_run(prompts, n_new, **kw):
    """``_bf16_engine_run`` with spec_tokens 3; also the sampler launches."""
    fam0 = family_call.launches
    outs, eng, counts = _bf16_engine_run(prompts, n_new, spec_tokens=3, **kw)
    return outs, eng, counts + (family_call.launches - fam0,)


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3"])
def test_graphed_verify_matches_eager(dev, greedy, kv_dtype):
    """Speculative decoding on repetitive prompts, five requests on four
    slots: the verify step replayed from CUDA graphs emits the eager
    step's tokens, sampled ones too (the seed rides the input buffer and
    the uniforms are a hash of it); each capture's warm-up runs one eager
    step more; drafts are accepted."""
    rng = np.random.default_rng(23)
    core = rng.integers(0, 256, 5).tolist()
    prompts = [core * 3, core * 2, rng.integers(0, 256, 9).tolist(),
               core * 4 + core[:2], rng.integers(0, 256, 20).tolist()]
    kw = dict(greedy=greedy, kv_dtype=kv_dtype, kv_scale=0.3)
    want, eager, (paged_e, norm_e, fam_e) = _spec_engine_run(
        prompts, 12, cuda_graphs=False, **kw)
    got, eng, (paged_g, norm_g, fam_g) = _spec_engine_run(prompts, 12, **kw)
    assert got == want
    assert eager.graphs.captures == 0 and eng.graphs.captures >= 1
    assert all(k[0] == "verify" for k in eng.graphs._graphs)
    assert eng.spec_stats == eager.spec_stats
    layers = eng.cfg.model.num_layers
    assert paged_g == paged_e + layers * eng.graphs.captures
    assert norm_g == norm_e + (2 * layers + 1) * eng.graphs.captures
    # sampled: two renorm launches and the draw a verify step
    assert fam_g == fam_e + (0 if greedy else 3 * eng.graphs.captures)
    if greedy:
        assert eng.spec_stats["accepted"] > 0


def test_chain_speculative_sampling_in_a_cuda_graph(dev):
    """The chain verification on one-hot drafts (the engine's call),
    captured with a device seed, replays with the seed that memory holds at
    replay: the eager call's output for that seed."""
    from flashinfer_tpu_torch.ops.sampling import chain_speculative_sampling

    gen = torch.Generator(device=dev).manual_seed(24)
    batch, num_spec, vocab = 8, 3, 128256
    target = torch.softmax(torch.randn(batch, num_spec + 1, vocab,
                                       device=dev, generator=gen) * 4, -1)
    ids = target[:, :num_spec].argmax(-1).to(torch.int32)
    ids[::2, 1] = 7  # some rejections
    one_hot = torch.nn.functional.one_hot(ids.long(), vocab).float()
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    chain_speculative_sampling(one_hot, ids, target, seed=seed)  # builds
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out, acc, _ = chain_speculative_sampling(one_hot, ids, target,
                                                 seed=seed)
    for new in (123, -7, 2**31 - 1):
        seed.fill_(new)
        g.replay()
        want = chain_speculative_sampling(one_hot, ids, target, seed=new)
        assert torch.equal(out, want[0]) and torch.equal(acc, want[1])
        assert bool((acc > 0).any()) and bool((acc < num_spec).any())


@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
def test_tiny_spec_engine_on_the_card_matches_cpu(dev, kv_dtype):
    """Greedy spec tokens of the f32 tiny engine on the card (graphed
    verify steps, every kernel on) equal the CPU engine's and the non-spec
    engine's."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    mc = LlamaConfig.tiny()
    rng = np.random.default_rng(25)
    core = rng.integers(0, mc.vocab_size, 4).tolist()
    prompts = [core * 3, core * 2 + core[:2],
               rng.integers(0, mc.vocab_size, 7).tolist()]
    outs, params, accepted = [], None, []
    for device, spec in (("cpu", 3), ("cuda", 3), ("cuda", 0)):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, kv_dtype=kv_dtype,
                           kv_scale=0.3, spec_tokens=spec, device=device)
        eng = LlamaServingEngine(cfg, seed=0, params=params)
        params = eng.params
        reqs = [eng.add_request(p, 8) for p in prompts]
        eng.run_to_completion(max_steps=100)
        outs.append([r.output for r in reqs])
        accepted.append(eng.spec_stats["accepted"])
    assert outs[0] == outs[1] == outs[2]
    assert accepted[0] == accepted[1] > 0


# name: (qo_len, kv_len, causal, window_left); with 8 q heads on 2 kv heads
# a bf16 CTA takes 128 packed rows (32 tokens) and keys come in tiles of
# 128 (64 for dv > 128 or d 256)
FLASH_SHAPES = {"prefill": (70, 70, True, -1), "chunk": (37, 150, True, -1),
                "window": (45, 200, True, 30), "full": (20, 90, False, -1),
                # causal, more queries than keys: the first rows see no key
                "qo_gt_kv": (90, 40, True, -1),
                # fewer keys than one tile; 80 packed rows
                "short": (20, 50, True, -1),
                # keys not a multiple of the tile, more tiles than K/V
                # stages (the ring wraps), 1200 packed rows
                "long": (300, 700, True, -1)}
FLASH_VARIANTS = ["default", "soft_cap", "alibi", "sink", "sigmoid", "mask",
                  "hnd"]


def _flash_case(dev, dtype, shape, variant, d, dv, hq=8, hkv=2, seed=0):
    """q, k, v and the keyword arguments of one case; ``shape`` is
    (qo_len, kv_len, causal, window_left)."""
    from flashinfer_tpu_torch.ops.attention.single import default_alibi_slopes
    from flashinfer_tpu_torch.ops.attention.variants import (
        FlashSigmoid,
        make_default_variant,
    )

    qo, kv, causal, window = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(qo, hq, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(kv, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(kv, hkv, dv, device=dev, generator=gen).to(dtype)
    kw = dict(causal=causal, window_left=window)
    if variant == "soft_cap":
        kw["variant"] = make_default_variant(logits_soft_cap=2.0)
        q = q * 4
    elif variant == "alibi":
        kw["variant"] = make_default_variant(use_alibi=True)
        kw["variant_params"] = {"alibi_slopes": default_alibi_slopes(hq, dev)}
    elif variant == "sink":
        kw["sink"] = torch.randn(hq, device=dev, generator=gen) * 3
    elif variant == "sigmoid":
        # prefill rows over hundreds of keys take sigmoid attention's bias
        # -log(n), which keeps a row's weights summing to ~1: the bf16 o
        # limit is set for unit-size P.V sums (with bias -1 over 700 keys
        # both the mma.sync and the wgmma kernels leave it at one element)
        long_rows = qo > 1 and kv > 256
        kw["variant"] = (FlashSigmoid(1.0, -math.log(kv)) if long_rows
                         else FlashSigmoid(0.5, -1.0))
    elif variant == "mask":
        mask = torch.rand(qo, kv, device=dev, generator=gen) < 0.5
        if qo > 1:
            mask[1] = False  # a row that sees no key
        kw["custom_mask"] = mask
    elif variant == "hnd":  # transposed HND views, read through strides:
        # K and V heads-major, and q too (its heads not contiguous)
        q, k, v = (x.transpose(0, 1).contiguous().transpose(0, 1)
                   for x in (q, k, v))
    return q, k, v, kw


def _check_flash(o, lse, ref_o, ref_lse, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(o, ref_o, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
        return
    diff = (o.float() - ref_o.float()).abs()
    assert bool((diff <= 2.0 ** -6 * ref_o.float().abs() + 2.0 ** -8).all()), \
        float(diff.max())
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128),
                                  (256, 256), (128, 64), (128, 192),
                                  (128, 256)])
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
@pytest.mark.parametrize("variant", FLASH_VARIANTS)
def test_flash_kernel_matches_plain(dev, dtype, d, dv, shape, variant):
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )

    q, k, v, kw = _flash_case(dev, dtype, FLASH_SHAPES[shape], variant, d, dv)
    before = flash_attention_dense.launches
    o, lse = flash_attention_dense(q, k, v, **kw)
    assert flash_attention_dense.launches == before + 1
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == ref_o.shape
    _check_flash(o, lse, ref_o, ref_lse, dtype)
    if variant == "mask":
        assert torch.isneginf(lse[1]).all() and not o[1].any()
    if shape == "qo_gt_kv" and variant not in ("sink", "sigmoid"):
        qo, kv = FLASH_SHAPES[shape][:2]  # queries before the first key
        assert torch.isneginf(lse[:qo - kv]).all() and not o[:qo - kv].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [100, 3000, 20000])
@pytest.mark.parametrize("variant", FLASH_VARIANTS)
@pytest.mark.parametrize("window", [-1, 1000])
def test_flash_kernel_split_kv(dev, dtype, kv_len, variant, window):
    """Decode-like shapes: one query, the key range split across CTAs (and
    merged by the kernel's merge launch) from 3000 keys on, one pass at
    100; with a sliding window the split covers only the window's tiles."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
        flash_num_splits,
    )

    q, k, v, kw = _flash_case(dev, dtype, (1, kv_len, False, window),
                              variant, 128, 128, hq=32, hkv=8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = flash_num_splits(1, kv_len, 32, 8, dtype, sms)
    assert (splits > 1) == (kv_len >= 3000)
    o, lse = flash_attention_dense(q, k, v, **kw)
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _check_flash(o, lse, ref_o, ref_lse, dtype)


@pytest.mark.parametrize("variant", ["default", "sink", "sigmoid"])
def test_flash_split_decode_in_a_cuda_graph(dev, variant):
    """A split decode captured in a CUDA graph and replayed on new inputs
    matches its plain version; the call allocates its outputs and the split
    scratch and nothing else (the merge runs in the kernel's second
    launch, with no PyTorch ops)."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
        flash_num_splits,
    )

    q, k, v, kw = _flash_case(dev, torch.bfloat16, (1, 20000, False, -1),
                              variant, 128, 128, hq=32, hkv=8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = flash_num_splits(1, 20000, 32, 8, torch.bfloat16, sms)
    assert splits > 1
    flash_attention_dense(q, k, v, **kw)  # builds and loads the library
    torch.cuda.synchronize()
    block = 512  # the caching allocator's rounding
    want_bytes = sum(-(-n // block) * block for n in (
        32 * 128 * 2, 32 * 4, splits * 32 * 128 * 4, splits * 32 * 4))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = flash_attention_dense(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= want_bytes
    del out
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        o, lse = flash_attention_dense(q, k, v, **kw)
    q.copy_(torch.randn_like(q))
    k.copy_(torch.randn_like(k))
    g.replay()
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _check_flash(o, lse, ref_o, ref_lse, torch.bfloat16)


def test_flash_kernel_refuses_what_it_cannot_run(dev):
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )
    from flashinfer_tpu_torch.ops.attention.variants import AttentionVariant

    q = torch.randn(4, 4, 64, device=dev)
    custom = AttentionVariant(name="mine",
                              query_transform=lambda p, x: x * 2)
    o, _ = flash_attention_dense(q, q, q, variant=custom)  # the variant JIT
    ref_o, _ = flash_attention_plain(q, q, q, variant=custom)
    torch.testing.assert_close(o, ref_o, atol=1e-4, rtol=1e-4)
    reduced = AttentionVariant(name="reduced",
                               query_transform=lambda p, x: x.sum(dim=-1))
    with pytest.raises(NotImplementedError, match="variant JIT.*sum"):
        flash_attention_dense(q, q, q, variant=reduced)
    with pytest.raises(TypeError):
        flash_attention_dense(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention_dense(q[..., :40], q[..., :40], q[..., :40])


@pytest.mark.parametrize("mode", ["NONE", "ALIBI", "ROPE_LLAMA"])
def test_single_request_on_the_card_matches_cpu(dev, mode):
    from flashinfer_tpu_torch.ops.attention.single import (
        single_decode_with_kv_cache,
        single_prefill_with_kv_cache,
    )
    from flashinfer_tpu_torch.ops.quantization import packbits

    gen = torch.Generator().manual_seed(5)
    q = torch.randn(30, 8, 64, generator=gen)
    k = torch.randn(2, 90, 64, generator=gen)  # HND
    v = torch.randn(2, 90, 64, generator=gen)
    packed = packbits(torch.rand(30 * 90, generator=gen) < 0.8)
    outs = []
    for device in ("cpu", "cuda"):
        t = [x.to(device) for x in (q, k, v, packed)]
        o, lse = single_prefill_with_kv_cache(
            t[0], t[1], t[2], packed_custom_mask=t[3], causal=True,
            kv_layout="HND", pos_encoding_mode=mode, return_lse=True)
        d, dlse = single_decode_with_kv_cache(
            t[0][0], t[1], t[2], kv_layout="HND", pos_encoding_mode=mode,
            return_lse=True)
        outs.append([x.cpu() for x in (o, lse, d, dlse)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pod_modes_on_the_card(dev, dtype):
    """Both POD modes on the card against the CPU (plain versions), and
    against each other."""
    from flashinfer_tpu_torch.ops.attention.pod import (
        PODWithPagedKVCacheWrapper,
    )

    rng = np.random.default_rng(2)
    hq, hkv, d, ps = 8, 2, 128, 16
    kv_lens = rng.integers(20, 300, 6)
    pages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    num_pages = int(indptr[-1]) + 8
    indices = rng.permutation(num_pages)[: indptr[-1]]
    free = [p for p in range(num_pages) if p not in set(indices.tolist())]
    last = kv_lens - (pages - 1) * ps
    gen = torch.Generator().manual_seed(3)
    qp, kp, vp = (torch.randn(n, h, d, generator=gen).to(dtype)
                  for n, h in ((40, hq), (100, hkv), (100, hkv)))
    qd = torch.randn(6, hq, d, generator=gen).to(dtype)
    kc, vc = (torch.randn(num_pages, hkv, ps, d, generator=gen).to(dtype)
              for _ in "kv")
    plan = (indptr, indices, last, hq, hkv, d, ps)
    kw = dict(kv_len_arr=kv_lens, kv_chunk_size=64)
    comb = dict(prefill_qo_len=40, prefill_kv_len=100,
                prefill_page_indices=free)
    res = {}
    for device in ("cpu", "cuda"):
        t = [x.to(device) for x in (qp, kp, vp, qd)]
        two = PODWithPagedKVCacheWrapper(device=device).plan(*plan, **kw)
        one = PODWithPagedKVCacheWrapper(device=device).plan(*plan, **kw,
                                                             **comb)
        res[device, "two"] = two.run(*t, (kc.to(device), vc.to(device)))
        res[device, "one"], _ = one.run(*t, (kc.to(device), vc.to(device)))
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for a, b in ((("cuda", "two"), ("cpu", "two")),
                 (("cuda", "one"), ("cpu", "one")),
                 (("cuda", "one"), ("cuda", "two"))):
        for x, y in zip(res[a], res[b]):
            torch.testing.assert_close(x.cpu().float(), y.cpu().float(),
                                       **tol)


# ------------------------------------------------------------ 8-bit weights

def _w8_weights(dev, wdt, e, k, n, nk, gen, ftz_codes=False):
    """8-bit weights quantized per output column, as the models' are:
    (weights [E, K, N] or [E, N, K], scales [E, N]). ``ftz_codes`` writes
    denormal codes and the NaN code into a few e4m3 weights, which the bit
    decode turns into +-0 and +-480."""
    w = torch.randn((e, n, k) if nk else (e, k, n), device=dev,
                    generator=gen) * k ** -0.5
    kdim = -1 if nk else -2
    top = 127.0 if wdt == torch.int8 else 448.0
    s = w.abs().amax(dim=kdim, keepdim=True).clamp_min(1e-30) / top
    if wdt == torch.int8:
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    else:
        q = (w / s).to(torch.float8_e4m3fn)
        if ftz_codes:
            b = q.view(torch.uint8).view(-1)
            b[::7] = 0x03  # a denormal
            b[3::29] = 0x86  # a negative denormal
            b[5::101] = 0x7F  # NaN, decoded to 480
    return q, s.reshape(e, n)


@pytest.mark.parametrize("mode", ["e4m3", "e4m3_ftz", "int8"])
@pytest.mark.parametrize("tm", [16, 32, 64, 128])
@pytest.mark.parametrize("nk", [False, True])
@pytest.mark.parametrize("rows", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("col", [False, True])
def test_grouped_gemm_8bit_modes_match_plain(dev, mode, tm, nk, rows, col):
    """The kernel's 8-bit modes against its plain version: e4m3 converted
    exactly or by the bit decode (denormal and NaN codes in the weights),
    linear int8; bf16 rows (tensor cores) and f32 rows (CUDA cores); one
    scale an expert or one an output column."""
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
    )

    rng = np.random.default_rng(tm + 7)
    k, n = 256, 384
    x, _, eot, sc = _gg_case(dev, torch.bfloat16, tm, k, n, nk, rng)
    x = x.to(rows)
    wdt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    gen = torch.Generator(device=dev).manual_seed(tm)
    w, col_sc = _w8_weights(dev, wdt, 6, k, n, nk, gen,
                            ftz_codes=mode == "e4m3_ftz")
    kw = dict(out_dtype=torch.float32, rhs_nk=nk,
              e4m3_ftz=mode == "e4m3_ftz")
    scales = col_sc if col else sc
    got = grouped_gemm_padded(x, w, eot, scales, **kw)
    want = grouped_gemm_padded_plain(x, w, eot, scales, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    out = torch.bfloat16 if rows == torch.bfloat16 else torch.float32
    _gg_check(got.to(out), want.to(out), eot, tm, out)


@pytest.mark.parametrize("wdt", [torch.float8_e4m3fn, torch.int8])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 32, 33, 200])
@pytest.mark.parametrize("k,n", [(96, 400), (160, 48), (4096, 1024)])
def test_w8_matmul_matches_plain(dev, wdt, xdt, rows, k, n):
    """``w8_matmul`` (one launch, tm 16 / 32 / 128 by rows, no padded copy:
    the kernel reads zeros past the rows and stores only them) against its
    plain version, JAX's ``_wmm`` arithmetic; K not a multiple of the
    64-deep stage, N ragged against the 128- and 256-column tiles. bf16:
    the plain version rounds the product to bf16 before the scale, the
    kernel once after it (one bf16 step, 2^-7, plus 1e-3 of the rms)."""
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        w8_matmul,
        w8_matmul_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(rows * 7 + k)
    w, s = _w8_weights(dev, wdt, 1, k, n, False, gen, ftz_codes=True)
    x = torch.randn(rows, k, device=dev, generator=gen).to(xdt)
    before = grouped_gemm_padded.launches
    got = w8_matmul(x, w[0], s)
    assert grouped_gemm_padded.launches == before + 1
    want = w8_matmul_plain(x, w[0], s)
    torch.cuda.synchronize()
    assert got.shape == (rows, n) and got.dtype == xdt
    rms = float(want.float().pow(2).mean().sqrt())
    rtol = 2 ** -7 if xdt == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 * rms)


def test_w8_matmul_refuses_what_the_kernel_cannot_run(dev):
    """bf16 rows need K % 32 == 0 and N % 16 == 0; the call raises, naming
    the constraint, and takes no other route."""
    from flashinfer_tpu_torch.ops.gemm_grouped import w8_matmul

    x = torch.randn(8, 48, device=dev).bfloat16()
    w = torch.zeros(48, 64, device=dev).to(torch.int8)
    s = torch.ones(1, 64, device=dev)
    with pytest.raises(ValueError, match="K % 32 == 0"):
        w8_matmul(x, w, s)
    with pytest.raises(ValueError, match="N % 16 == 0"):
        w8_matmul(torch.randn(8, 64, device=dev).bfloat16(),
                  torch.zeros(64, 40, device=dev).to(torch.int8),
                  torch.ones(1, 40, device=dev))


@pytest.mark.parametrize("wdt", [torch.float8_e4m3fn, torch.int8])
def test_w8_matmul_in_a_cuda_graph(dev, wdt):
    """Captured, then replayed on new rows written into the captured input:
    the eager call's output on those rows."""
    from flashinfer_tpu_torch.ops.gemm_grouped import w8_matmul

    gen = torch.Generator(device=dev).manual_seed(3)
    w, s = _w8_weights(dev, wdt, 1, 512, 768, False, gen)
    x = torch.randn(8, 512, device=dev, generator=gen).bfloat16()
    w8_matmul(x, w[0], s)  # builds
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = w8_matmul(x, w[0], s)
    for _ in range(2):
        x.copy_(torch.randn(8, 512, device=dev, generator=gen))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, w8_matmul(x, w[0], s))


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("mode", [dict(), dict(decode_window=4),
                                  dict(spec_tokens=3)],
                         ids=["decode", "window4", "spec3"])
def test_tiny_8bit_engine_on_the_card_matches_cpu(dev, wdt, mode):
    """Greedy tokens of the f32 tiny engine with 8-bit weights on the card
    (every matmul a grouped-GEMM launch on the CUDA cores, graphed steps)
    equal the CPU engine's (every plain version)."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    torch.backends.cuda.matmul.allow_tf32 = False
    mc = LlamaConfig.tiny()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist()
               for n in (9, 30, 4)]
    outs, params = [], None
    for device in ("cpu", "cuda"):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, weight_dtype=wdt,
                           device=device, **mode)
        eng = LlamaServingEngine(cfg, params=params, seed=0)
        params = {k: v.cpu() for k, v in eng.params.items()}
        before = grouped_gemm_padded.launches
        reqs = [eng.add_request(p, 6) for p in prompts]
        eng.run_to_completion(max_steps=100)
        outs.append([r.output for r in reqs])
    assert grouped_gemm_padded.launches > before
    assert outs[0] == outs[1]


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("greedy", [True, False])
def test_graphed_8bit_decode_matches_eager(dev, wdt, greedy):
    """The bf16 tiny engine with 8-bit weights: the decode step replayed
    from CUDA graphs emits the eager step's tokens, and the grouped GEMM
    runs every matmul of a step (4 a layer and the lm_head)."""
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 30, 4, 17, 12)]
    runs = []
    for graphs in (False, True):
        gg0 = grouped_gemm_padded.launches
        outs, eng, _ = _bf16_engine_run(prompts, 10, greedy=greedy,
                                        weight_dtype=wdt, cuda_graphs=graphs)
        runs.append((outs, eng, grouped_gemm_padded.launches - gg0))
    (want, eager, gg_e), (got, eng, gg_g) = runs
    assert got == want
    layers = eng.cfg.model.num_layers
    assert eng.graphs.captures >= 1
    assert gg_g == gg_e + (4 * layers + 1) * eng.graphs.captures
    assert gg_e >= (4 * layers + 1) * eager.decode_steps


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float8_e4m3fn,
                                 torch.int8])
@pytest.mark.parametrize("tm", [16, 32, 64, 128])
@pytest.mark.parametrize("nk", [False, True])
def test_grouped_gemm_split_k(dev, wdt, tm, nk):
    """Few tiles over a deep K (ragged: 992 is not a multiple of the
    64-deep stage): the kernel splits K and the last split of each tile
    sums the partials in split order. Against the plain version, bit for
    bit across launches (eager and replayed from a CUDA graph), with -1
    tiles and a ragged last column tile."""
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        _split_k,
        _tile_n,
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
    )

    rng = np.random.default_rng(tm + 11)
    k, n = 992, 400
    x, _, eot, sc = _gg_case(dev, torch.bfloat16, tm, 1024, n, nk, rng)
    x = x[:, :k].contiguous()
    gen = torch.Generator(device=dev).manual_seed(tm + 1)
    if wdt == torch.bfloat16:
        w = _gg_weights(dev, wdt, 6, k, n, nk, gen)
        scales = sc
    else:
        w, scales = _w8_weights(dev, wdt, 6, k, n, nk, gen)
    tile_n = _tile_n(tm, w.dtype, nk)
    assert _split_k(eot.numel() * -(-n // tile_n), k, 1, dev)[0] > 1
    kw = dict(out_dtype=torch.bfloat16, rhs_nk=nk)
    got = grouped_gemm_padded(x, w, eot, scales, **kw)
    want = grouped_gemm_padded_plain(x, w, eot, scales, **kw)
    torch.cuda.synchronize()
    _gg_check(got, want, eot, tm, torch.bfloat16)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        again = grouped_gemm_padded(x, w, eot, scales, **kw)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(again, got)


def test_fused_moe_mixtral_decode_routing(dev):
    """``fused_moe(backend="pallas")`` at the decode routing the Mixtral
    phase serves: 8 tokens, top-2 of 8 experts (Renormalize), 4096 <->
    14336, bf16 weights in [E, N, K]: the grouped-GEMM pipeline (two
    launches, tm 16) against the CPU's plain route."""
    from flashinfer_tpu_torch.ops.fused_moe import (
        RoutingMethodType,
        fused_moe,
        route_tokens,
        select_moe_tm,
    )
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    gen = torch.Generator(device=dev).manual_seed(21)
    m, e, top_k, hidden, inter = 8, 8, 2, 4096, 14336
    x = torch.randn(m, hidden, device=dev, generator=gen).bfloat16()
    w13 = torch.randn(e, 2 * inter, hidden, device=dev, generator=gen,
                      dtype=torch.bfloat16).mul_(hidden ** -0.5)
    w2 = torch.randn(e, hidden, inter, device=dev, generator=gen,
                     dtype=torch.bfloat16).mul_(inter ** -0.5)
    ids, sc = route_tokens(torch.randn(m, e, device=dev, generator=gen),
                           top_k, RoutingMethodType.Renormalize)
    assert select_moe_tm(m * top_k, e) == 16
    before = grouped_gemm_padded.launches
    got = fused_moe(x, w13, w2, ids, sc, out_dtype=torch.float32,
                    backend="pallas")
    torch.cuda.synchronize()
    assert grouped_gemm_padded.launches == before + 2
    want = fused_moe(*(t.cpu() for t in (x, w13, w2, ids, sc)),
                     out_dtype=torch.float32, backend="pallas")
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))


def test_tiny_mixtral_decode_on_the_card_matches_cpu(dev):
    """``chip_smoke.mixtral_serve`` on the f32 tiny Mixtral: the card (the
    paged, grouped-GEMM and norm kernels) emits the CPU's greedy tokens
    (every plain version), with the last step's logits to 1e-4."""
    import chip_smoke
    from flashinfer_tpu_torch.models.mixtral import (
        MixtralConfig,
        mixtral_init_weights,
    )
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded
    from flashinfer_tpu_torch.ops.norm import rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MixtralConfig.tiny()
    params = mixtral_init_weights(torch.Generator().manual_seed(3), cfg,
                                  "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (6, 2, 9)]
    runs = {}
    for device in ("cpu", "cuda"):
        before = [f.launches for f in (batch_paged_attention_run,
                                       grouped_gemm_padded, rmsnorm)]
        runs[device] = chip_smoke.mixtral_serve(
            torch, np, cfg, {k: v.to(device) for k, v in params.items()},
            prompts, 5, device=device, sampled=False, page_size=8, chunk=8)
    launched = [f.launches - b for f, b in zip(
        (batch_paged_attention_run, grouped_gemm_padded, rmsnorm), before)]
    assert all(launched), launched
    assert runs["cuda"]["outs"] == runs["cpu"]["outs"]
    torch.testing.assert_close(runs["cuda"]["logits"].cpu(),
                               runs["cpu"]["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("qo", [1, 16])
def test_cascade_on_the_card_matches_cpu(dev, dtype, layout, qo):
    """Two-level cascade attention (4 requests sharing a 64-token prefix,
    suffixes of 20-70 tokens, causal at the last level), decode (1 query
    token a request) and append (16): the card's levels (the paged kernel)
    against the CPU's (its plain version), and against flat attention on
    the card over the concatenated page tables."""
    from flashinfer_tpu_torch.ops.attention.batch import BatchAttention
    from flashinfer_tpu_torch.ops.attention.cascade import (
        MultiLevelCascadeAttentionWrapper,
    )

    ps, hq, hkv, d, chunk, nreq, prefix = 16, 8, 2, 128, 32, 4, 64
    rng = np.random.default_rng(qo)
    suffix = rng.integers(max(20, qo), 71, nreq)
    n_pre, n_suf = prefix // ps, -(-suffix // ps)
    num_pages = n_pre + int(n_suf.sum())
    perm = rng.permutation(num_pages)
    suf_indptr = np.concatenate([[0], np.cumsum(n_suf)])
    last = suffix - (n_suf - 1) * ps
    qo_indptr = np.arange(nreq + 1) * qo
    levels = [(np.array([0, nreq * qo]), np.array([0, n_pre]), perm[:n_pre],
               np.array([ps])),
              (qo_indptr, suf_indptr, perm[n_pre:], last)]
    flat_idx = np.concatenate([np.concatenate([perm[:n_pre],
                                               perm[n_pre + a:n_pre + b]])
                               for a, b in zip(suf_indptr[:-1],
                                               suf_indptr[1:])])
    shape = ((num_pages, hkv, ps, d) if layout == "HND"
             else (num_pages, ps, hkv, d))
    gen = torch.Generator().manual_seed(qo)
    q = torch.randn(nreq * qo, hq, d, generator=gen).to(dtype)
    k, v = (torch.randn(shape, generator=gen).to(dtype) for _ in range(2))
    out = {}
    for device in ("cpu", "cuda"):
        w = MultiLevelCascadeAttentionWrapper(2, kv_layout=layout,
                                              device=device)
        w.plan(*zip(*levels), hq, hkv, d, ps, causal=True,
               kv_chunk_size=chunk)
        out[device] = w.run(q.to(device), (k.to(device), v.to(device)),
                            return_lse=True)
    fw = BatchAttention(kv_layout=layout, device="cuda").plan(
        qo_indptr, suf_indptr + n_pre * np.arange(nreq + 1), flat_idx, last,
        hq, hkv, d, ps, causal=True, kv_chunk_size=chunk)
    flat = fw.run(q.to(dev), (k.to(dev), v.to(dev)), return_lse=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for want in (out["cpu"], tuple(t.cpu() for t in flat)):
        torch.testing.assert_close(out["cuda"][0].float().cpu(),
                                   want[0].float(), atol=tol, rtol=tol)
        torch.testing.assert_close(out["cuda"][1].cpu(), want[1], atol=1e-3,
                                   rtol=1e-4)


# ------------------------------------------- fused_moe's API entry points

def _moe_entry_case(name, gen):
    """(entry point, positional args, keyword args) at small widths the
    grouped-GEMM kernel takes, built on the CPU."""
    import importlib

    from flashinfer_tpu_torch.ops.fp4 import mxfp4_quantize

    moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")

    m, e, hidden, inter = 24, 8, 256, 128
    x = torch.randn(m, hidden, generator=gen) * 0.5
    w13 = torch.randn(e, 2 * inter, hidden, generator=gen) * 0.1
    w2 = torch.randn(e, hidden, inter, generator=gen) * 0.1
    logits = torch.randn(m, e, generator=gen)
    if name == "cutlass":
        ids, sc = moe.route_tokens(logits, 2)
        return moe.cutlass_fused_moe, (
            x.bfloat16(), ids, sc, w13.bfloat16(), w2.bfloat16(),
            torch.bfloat16), dict(quant_scales=[torch.tensor(0.5),
                                                torch.tensor(2.0)])
    if name == "fp8_per_tensor":
        return moe.trtllm_fp8_per_tensor_scale_moe, (
            logits, None, x.bfloat16(), (w13 / 0.05).to(torch.float8_e4m3fn),
            torch.tensor(0.05), (w2 / 0.05).to(torch.float8_e4m3fn),
            torch.tensor(0.05), e, 2, None, None, inter), dict(
                routing_method_type=moe.RoutingMethodType.Renormalize)
    if name == "fp8_block_scale":
        s13 = torch.rand(e, 2 * inter // 128, hidden // 128,
                         generator=gen) * 0.02 + 0.01
        s2 = torch.rand(e, hidden // 128, inter // 128, generator=gen) * 0.02 \
            + 0.01
        sx = torch.rand(m, hidden // 128, generator=gen) * 0.01 + 0.005

        def up(s):
            return s.repeat_interleave(128, 1).repeat_interleave(128, 2)
        return moe.trtllm_fp8_block_scale_moe, (
            logits, torch.randn(e, generator=gen) * 0.1,
            (x / sx.repeat_interleave(128, 1)).to(torch.float8_e4m3fn), sx,
            (w13 / up(s13)).to(torch.float8_e4m3fn), s13,
            (w2 / up(s2)).to(torch.float8_e4m3fn), s2, e, 4, 4, 2, inter), \
            dict(routed_scaling_factor=2.5)
    p13, sf13 = mxfp4_quantize(w13)
    p2, sf2 = mxfp4_quantize(w2)
    return moe.trtllm_fp4_block_scale_moe, (
        logits, None, x.bfloat16(), None, p13, sf13, p2, sf2), dict(
            num_experts=e, top_k=2, intermediate_size=inter)


@pytest.mark.parametrize("name", ["cutlass", "fp8_per_tensor",
                                  "fp8_block_scale", "fp4_block_scale"])
def test_moe_entry_points_on_the_card(dev, name):
    """Each entry point launches the grouped-GEMM kernel twice on the card
    and agrees with the CPU's plain pipeline and the card's plain ragged
    route (backend="xla") to 2e-2 of its largest output."""
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    gen = torch.Generator().manual_seed(31)
    fn, args, kw = _moe_entry_case(name, gen)
    want = fn(*args, **kw)
    on_card = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    before = grouped_gemm_padded.launches
    got = fn(*on_card, **kw)
    torch.cuda.synchronize()
    assert grouped_gemm_padded.launches == before + 2
    ragged = fn(*on_card, backend="xla", **kw)
    assert grouped_gemm_padded.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    for ref in (want, ragged.cpu()):
        torch.testing.assert_close(got.float().cpu(), ref.float(), rtol=2e-2,
                                   atol=2e-2 * float(ref.abs().max()))


# ------------------------------------------------------- the logits pipe

PIPES_ON_CARD = {
    "temp_softmax_topk_topp_sample": (
        ("Temperature", "Softmax", "TopK", "TopP", "Sample"),
        dict(temperature=0.7, top_k=40, top_p=0.9), 1),
    "softmax_sample": (("Softmax", "Sample"), {}, 1),
    "temp_softmax_minp_sample": (
        ("Temperature", "Softmax", "MinP", "Sample"),
        dict(temperature=0.7, min_p=0.05), 1),
    "topk_softmax_topp_sample": (("TopK", "Softmax", "TopP", "Sample"),
                                 dict(top_k=40, top_p=0.9), 2),
}


def _direct(name, logits, seed, params):
    """The sampler surface called directly, as each pipe compiles."""
    S = sampling_mod
    if name == "temp_softmax_topk_topp_sample":
        probs = torch.softmax((logits / params["temperature"]).float(), -1)
        return S.top_k_top_p_sampling_from_probs(
            probs, params["top_k"], params["top_p"], seed=seed)
    if name == "softmax_sample":
        return S.sampling_from_logits(logits, seed=seed)
    if name == "temp_softmax_minp_sample":
        probs = torch.softmax((logits / params["temperature"]).float(), -1)
        return S.min_p_sampling_from_probs(probs, params["min_p"], seed=seed)
    masked = S.top_k_mask_logits(logits, params["top_k"])
    return S.top_p_sampling_from_probs(torch.softmax(masked.float(), -1),
                                       params["top_p"], seed=seed)


@pytest.mark.parametrize("name", list(PIPES_ON_CARD))
def test_logits_pipes_on_the_card(dev, name):
    """Each pipe's tokens equal the direct sampler calls' on the card and
    the CPU pipe's (the kernel and its plain version draw the same tokens
    for a seed), with the sampler launches the compiled steps make."""
    from flashinfer_tpu_torch import logits_processor as lp

    names, params, launches = PIPES_ON_CARD[name]
    gen = torch.Generator().manual_seed(37)
    logits = torch.randn(8, 32000, generator=gen) * 3
    pipe = lp.LogitsPipe([getattr(lp, n)() for n in names])
    for seed in (3, 2**31 - 5):
        before = family_call.launches
        got = pipe(logits.to(dev), seed=seed, **params)
        torch.cuda.synchronize()
        assert family_call.launches == before + launches
        want = _direct(name, logits.to(dev), seed, params)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), pipe(logits, seed=seed, **params))
