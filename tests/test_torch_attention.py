"""Paged attention: the port's ``run_device_plan`` (plain version of the
CUDA kernel on the CPU) against the JAX package's Pallas kernel in
interpret mode, on the same plan blob, caches and queries.

Tolerances: f32 caches agree to atol 2e-5 (the two sum in different
orders). Both 8-bit paths see the same quantised values; e4m3 rounds q and
P to bf16 in both, so those cases are held to a bf16 rounding step of the
outputs (atol 1e-2), and int8 to atol 2e-5 like f32 (its values convert
exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.ops.attention import reference as jax_reference
from flashinfer_tpu.ops.attention import state as jax_state
from flashinfer_tpu.utils import TensorLayout as JaxLayout
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.attention.state import gather_merge_states
from flashinfer_tpu_torch.utils import TensorLayout

PS, HQ, HKV, D = 8, 4, 2, 32
TOL = {"model": 2e-5, "int8": 2e-5, "e4m3": 1e-2}
SCALES = {"model": (1.0, 1.0), "int8": (0.02, 0.03), "e4m3": (0.5, 0.25)}


def _batch(rng, mode):
    if mode == "decode":
        qo = np.ones(3, np.int64)
        kv = rng.integers(1, 60, 3)
    else:
        qo = rng.integers(3, 14, 2)
        kv = qo + rng.integers(0, 20, 2)
    npages = -(-kv // PS)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    total = int(indptr[-1]) + 2
    indices = rng.permutation(total)[: int(indptr[-1])].astype(np.int32)
    last = ((kv - 1) % PS) + 1
    return qo, kv, indptr, indices, last, total


def _caches(rng, layout, kv_dtype, pages, d=D, dv=D):
    """f32 caches (K with d columns, V with dv), quantised for the 8-bit
    containers: (numpy for JAX, tensor for the port). e4m3 goes to JAX as
    int8 bits, to the port as torch.float8_e4m3fn holding the same bits."""
    out = []
    for scale, width in zip(SCALES[kv_dtype], (d, dv)):
        shape = ((pages, HKV, PS, width) if layout == "HND"
                 else (pages, PS, HKV, width))
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if kv_dtype == "int8":
            t = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            out.append((t.numpy(), t))
        elif kv_dtype == "e4m3":
            t = (x / scale).to(torch.float8_e4m3fn)
            out.append((t.view(torch.int8).numpy(), t))
        else:
            out.append((x.numpy(), x))
    return out


@pytest.mark.parametrize("kv_dtype", ["model", "int8", "e4m3"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("mode,chunk", [("decode", 16), ("decode", 64),
                                        ("prefill", 16)])
def test_run_device_plan_matches_jax(mode, chunk, layout, kv_dtype):
    rng = np.random.default_rng([mode == "decode", chunk, layout == "HND"])
    _check_against_jax(rng, mode, chunk, layout, kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["model", "e4m3"])
@pytest.mark.parametrize("mode,chunk", [("decode", 16), ("prefill", 16)])
@pytest.mark.parametrize("d,dv", [(256, 256), (192, 128)])
def test_run_device_plan_wide_heads_match_jax(d, dv, mode, chunk, kv_dtype):
    """head_dim 256, and d 192 with dv 128 (V read at its own width), which
    the paged kernel serves on the card."""
    rng = np.random.default_rng([d, dv, mode == "decode"])
    _check_against_jax(rng, mode, chunk, "NHD" if d == dv else "HND",
                       kv_dtype, d, dv)


def _check_against_jax(rng, mode, chunk, layout, kv_dtype, d=D, dv=D):
    qo, kv, indptr, indices, last, pages = _batch(rng, mode)
    # a layer-stacked cache: this "layer" owns pages [pages, 2 * pages)
    offset = pages
    (kj, kt), (vj, vt) = _caches(rng, layout, kv_dtype, 2 * pages, d, dv)
    q = rng.standard_normal((int(qo.sum()), HQ, d)).astype(np.float32)
    k_scale, v_scale = SCALES[kv_dtype]
    causal = mode == "prefill"
    if mode == "decode":
        args = (indptr, indices, last, HQ, HKV, d, PS)
        kw = dict(kv_chunk_size=chunk, head_dim_vo=dv)
        jw = jax_batch.BatchDecodeWithPagedKVCacheWrapper(
            kv_layout=layout, backend="pallas")
        tw = torch_batch.BatchDecodeWithPagedKVCacheWrapper(
            kv_layout=layout, device="cpu")
    else:
        qo_indptr = np.concatenate([[0], np.cumsum(qo)])
        args = (qo_indptr, indptr, indices, last, HQ, HKV, d, PS)
        kw = dict(kv_chunk_size=chunk, causal=True, head_dim_vo=dv)
        jw = jax_batch.BatchPrefillWithPagedKVCacheWrapper(
            kv_layout=layout, backend="pallas", tile_q=16)
        tw = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
            kv_layout=layout, tile_q=16, device="cpu")
    jdp = jw.plan(*args, **kw).device_plan
    tdp = tw.plan(*args, **kw).device_plan
    assert tdp.meta.causal == causal
    if chunk == 16:
        assert tdp.meta.max_splits > 1  # the split-KV merge runs
    quant = None if kv_dtype == "model" else kv_dtype
    want, want_lse = jax_batch.run_device_plan(
        jdp, jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj),
        kv_layout=JaxLayout[layout], k_scale=k_scale, v_scale=v_scale,
        kv_indices_offset=offset, kv_dtype=quant, return_lse=True,
        interpret=True)
    got, got_lse = torch_batch.run_device_plan(
        tdp, torch.from_numpy(q), kt, vt, kv_layout=TensorLayout[layout],
        k_scale=k_scale, v_scale=v_scale, kv_indices_offset=offset,
        return_lse=True)
    tol = TOL[kv_dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(False, -1), (True, -1),
                                           (True, 5)])
def test_attention_reference_matches_jax(causal, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((7, HQ, D)).astype(np.float32)
    k = rng.standard_normal((12, HKV, D)).astype(np.float32)
    v = rng.standard_normal((12, HKV, D)).astype(np.float32)
    want, want_lse = jax_reference.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window_left=window)
    got, got_lse = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window_left=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5)


def test_gather_merge_states_matches_jax():
    rng = np.random.default_rng(5)
    T, h, tq, dv, rows, splits = 6, 2, 8, 16, 12, 4
    o = rng.standard_normal((T, h, tq, dv)).astype(np.float32)
    lse = rng.standard_normal((T, h, tq)).astype(np.float32)
    lse[0, :, :3] = -np.inf  # empty partials
    src = rng.integers(-1, T * tq, (rows, splits)).astype(np.int32)
    src[0] = -1  # a row with no partial at all
    want_o, want_s = jax_state.gather_merge_states(
        jnp.asarray(o), jnp.asarray(lse), jnp.asarray(src), tq)
    got_o, got_s = gather_merge_states(
        torch.from_numpy(o), torch.from_numpy(lse), torch.from_numpy(src), tq)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-5)


def test_wrapper_run_matches_dense_reference():
    """The plan/run wrapper against the dense oracle, request by request."""
    rng = np.random.default_rng(6)
    qo, kv, indptr, indices, last, pages = _batch(rng, "prefill")
    (_, kt), (_, vt) = _caches(rng, "HND", "model", pages)
    q = torch.from_numpy(
        rng.standard_normal((int(qo.sum()), HQ, D)).astype(np.float32))
    w = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="HND", device="cpu")
    w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr, indices, last,
           HQ, HKV, D, PS, causal=True, kv_chunk_size=16)
    out = w.run(q, (kt, vt))
    q0 = 0
    for r in range(len(qo)):
        pg = torch.from_numpy(indices[indptr[r]: indptr[r + 1]]).long()
        k = kt[pg].permute(0, 2, 1, 3).reshape(-1, HKV, D)[: kv[r]]
        v = vt[pg].permute(0, 2, 1, 3).reshape(-1, HKV, D)[: kv[r]]
        want, _ = attention_reference(q[q0: q0 + qo[r]], k, v, causal=True)
        torch.testing.assert_close(out[q0: q0 + qo[r]], want, atol=2e-5,
                                   rtol=2e-5)
        q0 += int(qo[r])


def test_slice_limits_raise():
    """What the first slices refused now computes: a decode plan on pages
    of 4 tokens and a prefill plan with a custom mask agree with the dense
    oracle. Running before planning still raises."""
    w = torch_batch.BatchDecodeWithPagedKVCacheWrapper(device="cpu")
    with pytest.raises(RuntimeError, match="plan"):
        w.run(torch.zeros(1, 4, 32), (torch.zeros(1), torch.zeros(1)))
    rng = np.random.default_rng(7)
    k, v = (torch.from_numpy(rng.standard_normal((3, HKV, 4, D)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, HQ, D)).astype(np.float32))
    w.plan([0, 2], [2, 0], [3], HQ, HKV, D, 4, kv_chunk_size=16)
    keys = [x[[2, 0]].permute(0, 2, 1, 3).reshape(8, HKV, D)[:7]
            for x in (k, v)]
    want, _ = attention_reference(q, *keys)
    torch.testing.assert_close(w.run(q, (k, v)), want, atol=2e-5, rtol=2e-5)

    mask = rng.random((3, 7)) > 0.3
    mask[:, 0] = True
    q3 = torch.from_numpy(rng.standard_normal((3, HQ, D)).astype(np.float32))
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 4)) for x in (k, v))
    p = torch_batch.BatchPrefillWithPagedKVCacheWrapper(device="cpu")
    p.plan([0, 3], [0, 1], [1], [7], HQ, HKV, D, 8, causal=True,
           kv_chunk_size=16, custom_mask=mask.ravel())
    keys = [x[1, :, :7].transpose(0, 1) for x in (kp, vp)]
    want, _ = attention_reference(q3, *keys, causal=True,
                                  custom_mask=torch.from_numpy(mask))
    torch.testing.assert_close(p.run(q3, (kp, vp)), want, atol=2e-5,
                               rtol=2e-5)


class _CudaMarked(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: the kernels'
    wrappers take their CUDA branch on it (dispatch only)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("hook", ["query_transform", "logits_mask",
                                  "output_transform", "logits_transform"])
def test_hooked_variant_on_a_cuda_call_raises(hook, monkeypatch):
    """A variant with a hook of the caller's own cannot enter a kernel
    built by nvcc: given CUDA tensors, the flash and paged wrappers raise
    ``NotImplementedError`` before any kernel is built or launched (JAX's
    paged kernel applies no output transform, so paged takes the other
    three), and never give way to the plain version. On the CPU the plain
    versions compute it."""
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.ops.attention.kernels import flash, paged
    from flashinfer_tpu_torch.ops.attention.variants import (
        AttentionVariant,
        DefaultAttention,
    )

    def no_kernel(name):
        raise AssertionError(f"kernel {name} built on a hooked call")

    monkeypatch.setattr(jit, "load", no_kernel)
    hooks = dict(
        query_transform=lambda p, x: x * 0.5,
        logits_mask=lambda p, qp, kp, h: (kp + h) % 3 != 0,
        output_transform=lambda p, o: o + 1.0,
        logits_transform=lambda p, s, qp, kp, h: s * 2.0)
    kernel = None if hook == "logits_transform" else DefaultAttention.kernel
    variant = AttentionVariant(name=hook, kernel=kernel,
                               **{hook: hooks[hook]})
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((12, HQ, D), (20, HKV, D), (20, HKV, D)))
    marked = [t.as_subclass(_CudaMarked) for t in (q, k, v)]
    launches = flash.flash_attention_dense.launches
    with pytest.raises(NotImplementedError, match="variant JIT"):
        flash.flash_attention_dense(*marked, causal=True, variant=variant)
    assert flash.flash_attention_dense.launches == launches
    o, lse = flash.flash_attention_dense(q, k, v, causal=True,
                                         variant=variant)
    plain_o, _ = flash.flash_attention_plain(q, k, v, causal=True)
    assert torch.isfinite(o).all() and not torch.equal(o, plain_o)
    if hook == "output_transform":
        return
    qo, kv, indptr, indices, last, pages = _batch(rng, "prefill")
    (_, kt), (_, vt) = _caches(rng, "NHD", "model", pages)
    w = torch_batch.BatchPrefillWithPagedKVCacheWrapper(
        kv_layout="NHD", device="cpu")
    w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr, indices, last,
           HQ, HKV, D, PS, causal=True, kv_chunk_size=16)
    dp = w.device_plan
    qp = torch.from_numpy(rng.standard_normal(
        (HKV, dp.meta.bucket_rows, D)).astype(np.float32))
    args = (qp, kt, vt, dp.segment("kv_indices"), dp.segment("plan"))
    kw = dict(tile_q=dp.meta.tile_q, group=HQ // HKV, causal=True,
              sm_scale=D ** -0.5, variant=variant)
    launches = paged.batch_paged_attention_run.launches
    with pytest.raises(NotImplementedError, match="variant JIT"):
        paged.batch_paged_attention_run(
            *(t.as_subclass(_CudaMarked) for t in args), **kw)
    assert paged.batch_paged_attention_run.launches == launches
    o, _ = paged.batch_paged_attention_run(*args, **kw)
    plain_o, _ = paged.paged_attention_plain(*args, **{**kw, "variant": None})
    assert torch.isfinite(o).all() and not torch.equal(o, plain_o)
