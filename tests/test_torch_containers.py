"""The JAX package's int8 containers of e4m3 bits, read by the port as JAX
reads them: ``run_device_plan(kv_dtype="e4m3")`` on int8 paged caches and
``fused_moe`` on int8 expert weights (also stored [E, K, N] with
``weights_kn``), against the JAX package on the same numpy bits, its
Pallas kernels in interpret mode.

Tolerances: e4m3 attention to 1e-2 (both round q and P to bf16, against
other maxima: ``tests/test_torch_attention.py``'s bound); fused MoE to
2e-2 of its largest output (bf16 intermediates on both sides, a sum on a
rounding boundary rounded the other way: ``tests/test_torch_moe.py``'s
bound); bf16 weights stored [E, K, N] the same."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.utils import TensorLayout

jax_moe = importlib.import_module("flashinfer_tpu.ops.fused_moe")
moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")

HQ, HKV, D, PS = 4, 2, 32, 16


def _e4m3_bits(x):
    """numpy f32 -> its e4m3 bits as an int8 numpy array."""
    return torch.from_numpy(x).to(torch.float8_e4m3fn).view(
        torch.int8).numpy()


@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_run_device_plan_reads_int8_as_e4m3(layout, mode):
    """``kv_dtype="e4m3"`` reads an int8 cache as e4m3 bits (JAX's
    ``run_device_plan``, batch.py:353-354); without it the port reads the
    same cache as linear int8, which differs."""
    rng = np.random.default_rng([len(layout), mode == "decode"])
    kv_lens = np.asarray([37, 5, 70])
    qo_lens = np.ones(3, np.int64) if mode == "decode" else np.asarray(
        [9, 5, 14])
    pages = -(-kv_lens // PS)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    total = int(indptr[-1]) + 2
    indices = rng.permutation(total)[: indptr[-1]]
    last = kv_lens - (pages - 1) * PS
    shape = ((total, HKV, PS, D) if layout == "HND" else (total, PS, HKV, D))
    k8, v8 = (_e4m3_bits(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))
    q = rng.standard_normal((int(qo_lens.sum()), HQ, D)).astype(np.float32)
    args = (np.concatenate([[0], np.cumsum(qo_lens)]), indptr, indices,
            last, HQ, HKV, D, PS)
    kw = dict(causal=mode == "prefill", kv_chunk_size=32)
    jw = jax_batch.BatchPrefillWithPagedKVCacheWrapper(kv_layout=layout,
                                                       backend="pallas")
    tw = torch_batch.BatchPrefillWithPagedKVCacheWrapper(kv_layout=layout,
                                                         device="cpu")
    jw.plan(*args, **kw)
    tw.plan(*args, **kw)
    want = jax_batch.run_device_plan(
        jw.device_plan, jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        kv_layout=jax_batch.TensorLayout[layout], k_scale=0.5, v_scale=0.7,
        kv_dtype="e4m3", interpret=True)
    tk, tv = torch.from_numpy(k8), torch.from_numpy(v8)
    got = torch_batch.run_device_plan(
        tw.device_plan, torch.from_numpy(q), tk, tv,
        kv_layout=TensorLayout[layout], k_scale=0.5, v_scale=0.7,
        kv_dtype="e4m3")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2)
    assert tk.dtype == torch.int8  # read through a view, not converted
    linear = torch_batch.run_device_plan(
        tw.device_plan, torch.from_numpy(q), tk, tv,
        kv_layout=TensorLayout[layout], k_scale=0.5, v_scale=0.7)
    assert not torch.allclose(linear, got, atol=1e-2)


def _moe_case(rng, m=24, e=4, hidden=128, inter=128, top_k=2):
    x = rng.standard_normal((m, hidden)).astype(np.float32)
    w13 = (rng.standard_normal((e, 2 * inter, hidden)) * 0.1).astype(
        np.float32)
    w2 = (rng.standard_normal((e, hidden, inter)) * 0.1).astype(np.float32)
    ids, sc = jax_moe.route_tokens(
        jnp.asarray(rng.standard_normal((m, e)).astype(np.float32)), top_k)
    return x, w13, w2, ids, sc


def _bf16(x):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("weights_kn", [False, True])
def test_fused_moe_int8_containers_match_jax(weights_kn, backend):
    """int8 weights are e4m3 containers with a scale an expert (JAX's
    Pallas route, fused_moe.py:262-270), stored [E, N, K] or, with
    ``weights_kn``, [E, K, N]; the port's kernel route (its plain version
    here) and its ragged route read both layouts."""
    rng = np.random.default_rng(11 + weights_kn)
    x, w13, w2, ids, sc = _moe_case(rng)
    s13 = np.asarray([0.02, 0.03, 0.025, 0.04], np.float32)
    s2 = np.asarray([0.03, 0.02, 0.05, 0.035], np.float32)
    b13 = _e4m3_bits(w13 / s13[:, None, None])
    b2 = _e4m3_bits(w2 / s2[:, None, None])
    if weights_kn:
        b13, b2 = (np.ascontiguousarray(b.transpose(0, 2, 1))
                   for b in (b13, b2))
    jx, tx = _bf16(x)
    want = jax_moe.fused_moe(
        jx, jnp.asarray(b13), jnp.asarray(b2), ids, sc,
        w13_scale=jnp.asarray(s13), w2_scale=jnp.asarray(s2),
        backend="pallas", interpret=True, out_dtype=jnp.float32,
        weights_kn=weights_kn)
    t13, t2 = torch.from_numpy(b13), torch.from_numpy(b2)
    got = moe.fused_moe(tx, t13, t2, torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(sc)),
                        w13_scale=torch.from_numpy(s13),
                        w2_scale=torch.from_numpy(s2),
                        out_dtype=torch.float32, weights_kn=weights_kn,
                        backend=backend)
    assert t13.dtype == torch.int8  # read through a view
    _close(got, want)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_fused_moe_weights_kn_bf16_matches_jax(backend):
    """bf16 weights stored [E, K, N] (``weights_kn=True``), against JAX's
    Pallas route on the same layout, and against the port's own [E, N, K]
    call on the transposed weights."""
    rng = np.random.default_rng(17)
    x, w13, w2, ids, sc = _moe_case(rng)
    (jx, tx), (j13, t13), (j2, t2) = _bf16(x), _bf16(w13), _bf16(w2)
    k13, k2 = (t.transpose(1, 2).contiguous() for t in (t13, t2))
    want = jax_moe.fused_moe(jx, jnp.swapaxes(j13, 1, 2),
                             jnp.swapaxes(j2, 1, 2), ids, sc,
                             backend="pallas", interpret=True,
                             weights_kn=True)
    tids, tsc = (torch.from_numpy(np.asarray(a)) for a in (ids, sc))
    got = moe.fused_moe(tx, k13, k2, tids, tsc, weights_kn=True,
                        backend=backend)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    nk = moe.fused_moe(tx, t13, t2, tids, tsc, backend=backend)
    torch.testing.assert_close(got, nk, atol=0, rtol=0)
