"""MLA paged attention, the page appends and the MLA rope prologue: the
port (plain versions of the kernels on the CPU) against the JAX package,
its Pallas MLA kernel in interpret mode (tile_k 8), on the same numpy
inputs and plans.

Tolerances: f32 caches to 2e-5 (the two sum in different orders); bf16
q and caches to 2e-2, since both round P to bf16 (the TPU kernel against
the running maximum of each 8-key sub-tile, the port's plain version
against the row's maximum) and round o to bf16. The
8-bit caches see the same quantised values on both sides, but the TPU
kernel rounds P to bf16 before P.V (its 8-bit caches decode to bf16)
against the running maximum of each 8-key sub-tile, the port's plain
version against the chunk's maximum: e4m3 and linear int8 are held to
1e-2, a few bf16 rounding steps of P. The e4m3 caches avoid e4m3
denormals, which the TPU bit decode approximates (ROADMAP Queue 3), and
go to JAX as their int8 bits (``.view(torch.int8)``). Linear int8 is held
to the Pallas path, not to JAX's ``backend="reference"``, which reads
every int8 cache as e4m3 bits. Appends and the cos/sin cache are exact;
the roped and quantised e4m3 bits agree but for rare rounding-boundary
ties (>= 99% here, f32 rope in other orders)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention.mla import (
    BatchMLAPagedAttentionWrapper as JaxMLA,
)
from flashinfer_tpu_torch.ops.attention.mla import (
    BatchMLAPagedAttentionWrapper,
)

jax_page = importlib.import_module("flashinfer_tpu.ops.page")
jax_rope = importlib.import_module("flashinfer_tpu.ops.rope")
page = importlib.import_module("flashinfer_tpu_torch.ops.page")
rope = importlib.import_module("flashinfer_tpu_torch.ops.rope")

PS, HEADS, D_CKV, D_KPE, PAGES = 4, 4, 64, 32, 40
SCALES = {"f32": (1.0, 1.0), "e4m3": (0.11, 0.07), "int8": (0.02, 0.03),
          "bf16": (1.0, 1.0)}
TOL = {"f32": 2e-5, "e4m3": 1e-2, "int8": 1e-2, "bf16": 2e-2}


def _page_table(rng, kv_lens):
    npages = [-(-s // PS) for s in kv_lens]
    indptr = np.concatenate([[0], np.cumsum(npages)]).astype(np.int32)
    indices = rng.permutation(PAGES)[: indptr[-1]].astype(np.int32)
    return indptr, indices


def _cache(rng, dtype, scale, width):
    """(numpy array for JAX, tensor for the port) of one cache."""
    x = rng.standard_normal((PAGES, PS, width)).astype(np.float32)
    if dtype == "e4m3":
        q = x / scale
        q = np.sign(q) * np.maximum(np.abs(q), 2.0 ** -5)  # no denormals
        t = torch.from_numpy(q).to(torch.float8_e4m3fn)
        return t.view(torch.int8).numpy(), t
    if dtype == "int8":
        t = torch.from_numpy(np.clip(np.round(x / scale), -127, 127)).to(
            torch.int8)
        return t.numpy(), t
    if dtype == "bf16":  # the same bf16 values on both sides
        t = torch.from_numpy(x).bfloat16()
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return x, torch.from_numpy(x)


# (kv_lens, qo_lens, causal, kv_chunk_size, kpe cache width)
CASES = {
    "decode": ([9, 22, 3], [1, 1, 1], False, None, D_KPE),
    "split_kv": ([70, 33], [1, 1], False, 16, D_KPE),
    "causal": ([12, 30], [5, 9], True, 16, D_KPE),
    "prepadded_kpe": ([9, 22, 3], [1, 1, 1], False, 8, 128),
}


@pytest.mark.parametrize("dtype", ["f32", "e4m3", "int8", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mla_wrapper_matches_jax_pallas(case, dtype):
    kv_lens, qo_lens, causal, chunk, kpe_width = CASES[case]
    rng = np.random.default_rng([list(CASES).index(case), len(dtype)])
    indptr, indices = _page_table(rng, kv_lens)
    ckv_scale, kpe_scale = SCALES[dtype]
    (ckv_j, ckv_t) = _cache(rng, dtype, ckv_scale, D_CKV)
    (kpe_j, kpe_t) = _cache(rng, dtype, kpe_scale, kpe_width)
    nnz = sum(qo_lens)
    q_nope = rng.standard_normal((nnz, HEADS, D_CKV)).astype(np.float32)
    q_pe = rng.standard_normal((nnz, HEADS, D_KPE)).astype(np.float32)
    q_t = [torch.from_numpy(q_nope), torch.from_numpy(q_pe)]
    q_j = [jnp.asarray(q_nope), jnp.asarray(q_pe)]
    if dtype == "bf16":  # bf16 q: the served path's numerics
        q_t = [t.bfloat16() for t in q_t]
        q_j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in q_t]
    qo_indptr = np.concatenate([[0], np.cumsum(qo_lens)])
    args = (qo_indptr, indptr, indices, np.asarray(kv_lens), HEADS, D_CKV,
            D_KPE, PS)
    kw = dict(causal=causal, kv_chunk_size=chunk)
    scales = dict(ckv_scale=ckv_scale, kpe_scale=kpe_scale)
    jax_cache_dtype = "int8" if dtype == "int8" else "e4m3"

    jw = JaxMLA(backend="pallas", tile_k=8)
    jw.plan(*args, **kw)
    want, want_lse = jw.run(*q_j, jnp.asarray(ckv_j), jnp.asarray(kpe_j),
                            return_lse=True, interpret=True,
                            cache_dtype=jax_cache_dtype, **scales)
    tw = BatchMLAPagedAttentionWrapper(device="cpu")
    tw.plan(*args, **kw)
    if case == "split_kv":
        assert tw.device_plan.meta.max_splits > 1  # the merge runs
    got, got_lse = tw.run(*q_t, ckv_t, kpe_t, return_lse=True, **scales)
    tol = TOL[dtype]
    assert got.dtype == q_t[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_mla_reference_backend_matches_kernel_path(dtype):
    """The port's dense oracle reads linear int8 as int8 (the JAX
    package's reads it as e4m3 bits)."""
    kv_lens, qo_lens, causal, chunk, _ = CASES["causal"]
    rng = np.random.default_rng(9)
    indptr, indices = _page_table(rng, kv_lens)
    ckv_scale, kpe_scale = SCALES[dtype]
    _, ckv = _cache(rng, dtype, ckv_scale, D_CKV)
    _, kpe = _cache(rng, dtype, kpe_scale, D_KPE)
    nnz = sum(qo_lens)
    q_nope = torch.from_numpy(
        rng.standard_normal((nnz, HEADS, D_CKV)).astype(np.float32))
    q_pe = torch.from_numpy(
        rng.standard_normal((nnz, HEADS, D_KPE)).astype(np.float32))
    outs = []
    for backend in ("auto", "reference"):
        w = BatchMLAPagedAttentionWrapper(backend=backend, device="cpu")
        w.plan(np.concatenate([[0], np.cumsum(qo_lens)]), indptr, indices,
               np.asarray(kv_lens), HEADS, D_CKV, D_KPE, PS, causal=causal,
               kv_chunk_size=chunk)
        outs.append(w.run(q_nope, q_pe, ckv, kpe, return_lse=True,
                          ckv_scale=ckv_scale, kpe_scale=kpe_scale))
    tol = TOL[dtype]
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=tol, rtol=tol)
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=tol, rtol=tol)


def test_mla_run_before_plan_raises():
    w = BatchMLAPagedAttentionWrapper(device="cpu")
    with pytest.raises(RuntimeError, match="plan"):
        w.run(torch.zeros(1, 2, 16), torch.zeros(1, 2, 16),
              torch.zeros(1, 4, 16), torch.zeros(1, 4, 16))


@pytest.mark.parametrize("fp8", [False, True])
def test_append_paged_mla_kv_cache_matches_jax(fp8):
    rng = np.random.default_rng(11)
    kv_lens = [5, 9, 2]
    indptr, indices = _page_table(rng, kv_lens)
    last = np.asarray([(n - 1) % PS + 1 for n in kv_lens], np.int32)
    batch_idx = np.asarray([0, 1, 1, 2, 0], np.int32)
    pos = np.asarray([4, 7, 8, 1, 3], np.int32)
    valid = np.asarray([True, True, False, True, True])
    ckv_new = rng.standard_normal((5, D_CKV)).astype(np.float32)
    kpe_new = rng.standard_normal((5, D_KPE)).astype(np.float32)
    ckv0 = rng.standard_normal((PAGES, PS, D_CKV)).astype(np.float32)
    kpe0 = rng.standard_normal((PAGES, PS, D_KPE)).astype(np.float32)
    if fp8:  # the JAX package appends e4m3 bits into int8 containers
        def q8(x):
            return torch.from_numpy(x).to(torch.float8_e4m3fn)
        t_args = [q8(x) for x in (ckv_new, kpe_new, ckv0, kpe0)]
        j_args = [jnp.asarray(t.view(torch.int8).numpy()) for t in t_args]
        t_args = [t_args[0], t_args[1], t_args[2].clone(), t_args[3].clone()]
    else:
        j_args = [jnp.asarray(x) for x in (ckv_new, kpe_new, ckv0, kpe0)]
        t_args = [torch.from_numpy(x.copy())
                  for x in (ckv_new, kpe_new, ckv0, kpe0)]
    tables = (indices, indptr, last)
    want = jax_page.append_paged_mla_kv_cache(
        j_args[0], j_args[1], jnp.asarray(batch_idx), jnp.asarray(pos),
        j_args[2], j_args[3], *map(jnp.asarray, tables),
        valid=jnp.asarray(valid))
    got = page.append_paged_mla_kv_cache(
        t_args[0], t_args[1], torch.from_numpy(batch_idx),
        torch.from_numpy(pos), t_args[2], t_args[3],
        *map(torch.from_numpy, tables), valid=torch.from_numpy(valid))
    assert got[0] is t_args[2]  # written in place
    for g, w in zip(got, want):
        g = g.view(torch.int8) if fp8 else g
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_append_paged_kv_cache_matches_jax(layout):
    rng = np.random.default_rng(12)
    kv_lens = np.asarray([6, 3])
    indptr, indices = _page_table(rng, kv_lens)
    last = np.asarray([(n - 1) % PS + 1 for n in kv_lens], np.int32)
    append_indptr = np.asarray([0, 4, 6], np.int32)
    seq_lens = jax_page.get_seq_lens(jnp.asarray(indptr), jnp.asarray(last),
                                     PS)
    np.testing.assert_array_equal(
        page.get_seq_lens(torch.from_numpy(indptr), torch.from_numpy(last),
                          PS).numpy(), np.asarray(seq_lens))
    jb, jp = jax_page.get_batch_indices_positions(
        jnp.asarray(append_indptr), seq_lens, 6)
    tb, tp = page.get_batch_indices_positions(
        torch.from_numpy(append_indptr),
        torch.from_numpy(np.asarray(seq_lens)), 6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    shape = (PAGES, 2, PS, 8) if layout == "HND" else (PAGES, PS, 2, 8)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    k_new, v_new = (rng.standard_normal((6, 2, 8)).astype(np.float32)
                    for _ in "kv")
    want = jax_page.append_paged_kv_cache(
        jnp.asarray(k_new), jnp.asarray(v_new), jb, jp,
        (jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(indices),
        jnp.asarray(indptr), jnp.asarray(last), kv_layout=layout)
    got = page.append_paged_kv_cache(
        torch.from_numpy(k_new), torch.from_numpy(v_new), tb, tp,
        (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())),
        torch.from_numpy(indices), torch.from_numpy(indptr),
        torch.from_numpy(last), kv_layout=layout)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rope_cos_sin_cache_matches_jax():
    want = jax_rope.rope_cos_sin_cache(64, D_KPE, rope_theta=1e4)
    got = rope.rope_cos_sin_cache(64, D_KPE, rope_theta=1e4, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("is_neox", [True, False])
def test_mla_rope_quantize_fp8_matches_jax(is_neox):
    rng = np.random.default_rng(13)
    n = 24
    q_rope = rng.standard_normal((n, HEADS, D_KPE)).astype(np.float32)
    k_rope = rng.standard_normal((n, D_KPE)).astype(np.float32)
    q_nope = rng.standard_normal((n, HEADS, D_CKV)).astype(np.float32)
    k_nope = rng.standard_normal((n, D_CKV)).astype(np.float32)
    pos = rng.integers(0, 64, n).astype(np.int32)
    cs = rope.rope_cos_sin_cache(64, D_KPE, device="cpu")
    kw = dict(is_neox=is_neox, quant_scale_q=2.0, quant_scale_kv=4.0)
    for quantize_q in (True, False):
        want = jax_rope.mla_rope_quantize_fp8(
            *map(jnp.asarray, (q_rope, k_rope, q_nope, k_nope)),
            jnp.asarray(cs.numpy()), jnp.asarray(pos),
            quantize_dtype=jnp.int8, quantize_q=quantize_q, **kw)
        got = rope.mla_rope_quantize_fp8(
            *map(torch.from_numpy, (q_rope, k_rope, q_nope, k_nope)), cs,
            torch.from_numpy(pos), quantize_q=quantize_q, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            if quantize_q or i % 2:  # e4m3 bits against JAX's int8 bits
                assert g.dtype == torch.float8_e4m3fn
                same = np.mean(g.view(torch.int8).numpy() == np.asarray(w))
                assert same >= 0.99, same
            else:  # unquantized q: roped in its own dtype
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5, rtol=1e-5)
