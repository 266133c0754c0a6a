"""fused_moe's four API entry points: the port (the grouped-GEMM pipeline's
plain version on the CPU, and the ragged_dot route) against the JAX
package's functions (its ragged_dot route on the CPU), on the same numpy
inputs.

Tolerances: bf16 outputs to 2e-2 relative plus 2e-2 of the output's
largest magnitude, as for ``fused_moe`` in bf16 (tests/test_torch_moe.py:
x, h1 and the activation are rounded to bf16 on both sides, and a sum on a
rounding boundary can round the other way); per-tensor e4m3 weights to
3e-2 of the largest magnitude, since the port converts e4m3 denormals
exactly where JAX's bit decode flushes them (~1% of these Gaussian
weights' codes). The block-scale entry point's dequantized weights and rows
are bit for bit JAX's; the fp4 entry point's to 1e-6."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax_moe = importlib.import_module("flashinfer_tpu.ops.fused_moe")
jax_fp4 = importlib.import_module("flashinfer_tpu.ops.fp4")
moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")


def _bf16(x):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _e4m3(x):
    """numpy f32 -> (JAX's int8 container of the e4m3 bits, the same bits
    as a torch float8_e4m3fn tensor)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(torch.float8_e4m3fn)
    return jnp.asarray(t.view(torch.int8).numpy()), t


def _close(got, want, rel=2e-2, rel_max=2e-2):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rel,
                               atol=rel_max * np.abs(want).max())


def _inputs(rng, m, e, hidden, inter):
    x = (rng.standard_normal((m, hidden)) * 0.5).astype(np.float32)
    w13 = (rng.standard_normal((e, 2 * inter, hidden)) * 0.1).astype(
        np.float32)
    w2 = (rng.standard_normal((e, hidden, inter)) * 0.1).astype(np.float32)
    logits = rng.standard_normal((m, e)).astype(np.float32)
    return x, w13, w2, logits


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_cutlass_fused_moe_matches_jax(backend):
    rng = np.random.default_rng(0)
    m, e, hidden, inter, top_k = 12, 4, 64, 32, 2
    x, w13, w2, logits = _inputs(rng, m, e, hidden, inter)
    ids, sc = jax_moe.route_tokens(jnp.asarray(logits), top_k)
    s13, s2 = np.full(e, 0.5, np.float32), np.full(e, 2.0, np.float32)
    (jx, tx), (j13, t13), (j2, t2) = _bf16(x), _bf16(w13), _bf16(w2)
    want = jax_moe.cutlass_fused_moe(
        jx, ids, sc, j13, j2, jnp.bfloat16,
        quant_scales=[jnp.asarray(s13), jnp.asarray(s2)], tp_size=1,
        ep_size=1)
    got = moe.cutlass_fused_moe(
        tx, torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(sc)),
        t13, t2, torch.bfloat16,
        quant_scales=[torch.from_numpy(s13), torch.from_numpy(s2)],
        tp_size=1, ep_size=1, backend=backend)
    _close(got, want)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_trtllm_fp8_per_tensor_scale_moe_matches_jax(backend):
    rng = np.random.default_rng(1)
    m, e, hidden, inter, top_k = 12, 8, 64, 32, 2
    x, w13, w2, logits = _inputs(rng, m, e, hidden, inter)
    (j13, t13), (j2, t2) = _e4m3(w13 / 0.05), _e4m3(w2 / 0.05)
    jx, tx = _bf16(x)
    args = dict(num_experts=e, top_k=top_k, n_group=None, topk_group=None,
                intermediate_size=inter,
                routing_method_type=moe.RoutingMethodType.Renormalize)
    want = jax_moe.trtllm_fp8_per_tensor_scale_moe(
        jnp.asarray(logits), None, jx, j13, jnp.asarray(0.05), j2,
        jnp.asarray(0.05), **{**args, "routing_method_type":
                              jax_moe.RoutingMethodType.Renormalize})
    got = moe.trtllm_fp8_per_tensor_scale_moe(
        torch.from_numpy(logits), None, tx, t13, torch.tensor(0.05), t2,
        torch.tensor(0.05), backend=backend, **args)
    _close(got, want, rel_max=3e-2)


def _block_case(rng):
    m, e, hidden, inter = 6, 8, 256, 128
    x, w13, w2, logits = _inputs(rng, m, e, hidden, inter)
    s13 = rng.uniform(0.5, 2.0, (e, 2 * inter // 128, hidden // 128)).astype(
        np.float32) * 0.02
    s2 = rng.uniform(0.5, 2.0, (e, hidden // 128, inter // 128)).astype(
        np.float32) * 0.02
    sx = rng.uniform(0.5, 2.0, (m, hidden // 128)).astype(np.float32) * 0.01
    up = lambda s: np.repeat(np.repeat(s, 128, 1), 128, 2)  # noqa: E731
    (j13, t13), (j2, t2) = _e4m3(w13 / up(s13)), _e4m3(w2 / up(s2))
    jx, tx = _e4m3(x / np.repeat(sx, 128, 1))
    bias = (0.1 * rng.standard_normal(e)).astype(np.float32)
    return (logits, bias, (jx, tx), sx, (j13, t13), s13, (j2, t2), s2,
            dict(num_experts=e, top_k=4, n_group=4, topk_group=2,
                 intermediate_size=inter, routed_scaling_factor=2.5))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_trtllm_fp8_block_scale_moe_matches_jax(backend):
    rng = np.random.default_rng(2)
    logits, bias, (jx, tx), sx, (j13, t13), s13, (j2, t2), s2, kw = \
        _block_case(rng)
    want = jax_moe.trtllm_fp8_block_scale_moe(
        jnp.asarray(logits), jnp.asarray(bias), jx, jnp.asarray(sx), j13,
        jnp.asarray(s13), j2, jnp.asarray(s2), **kw)
    got = moe.trtllm_fp8_block_scale_moe(
        torch.from_numpy(logits), torch.from_numpy(bias), tx,
        torch.from_numpy(sx), t13, torch.from_numpy(s13), t2,
        torch.from_numpy(s2), backend=backend, **kw)
    _close(got, want)


def test_block_scale_dequant_is_jaxs_bits(monkeypatch):
    """The dequantized rows and weights the block-scale entry point hands
    to fused_moe equal JAX's, bit for bit, a chunk of experts at a time."""
    rng = np.random.default_rng(3)
    logits, bias, (jx, tx), sx, (j13, t13), s13, (j2, t2), s2, kw = \
        _block_case(rng)
    seen = {}

    def spy(name):
        def fn(hs, w13, w2, ids, scales, **k):
            seen[name] = (hs, w13, w2)
            return hs
        return fn

    monkeypatch.setattr(jax_moe, "fused_moe", spy("jax"))
    monkeypatch.setattr(moe, "fused_moe", spy("torch"))
    monkeypatch.setattr(moe, "_DEQUANT_EXPERTS", 3)  # a ragged last chunk
    jax_moe.trtllm_fp8_block_scale_moe(
        jnp.asarray(logits), None, jx, jnp.asarray(sx), j13,
        jnp.asarray(s13), j2, jnp.asarray(s2), **kw)
    moe.trtllm_fp8_block_scale_moe(
        torch.from_numpy(logits), None, tx, torch.from_numpy(sx), t13,
        torch.from_numpy(s13), t2, torch.from_numpy(s2), **kw)
    for j, t in zip(seen["jax"], seen["torch"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(j).view(np.int16))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_trtllm_fp4_block_scale_moe_matches_jax(backend):
    rng = np.random.default_rng(4)
    m, e, hidden, inter, top_k = 10, 4, 64, 64, 2
    x, w13, w2, logits = _inputs(rng, m, e, hidden, inter)
    p13, sf13 = jax_fp4.mxfp4_quantize(jnp.asarray(w13))
    p2, sf2 = jax_fp4.mxfp4_quantize(jnp.asarray(w2))
    jx, tx = _bf16(x)
    want = jax_moe.trtllm_fp4_block_scale_moe(
        jnp.asarray(logits), None, jx, None, p13, sf13, p2, sf2,
        num_experts=e, top_k=top_k, intermediate_size=inter)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got = moe.trtllm_fp4_block_scale_moe(
        t(logits), None, tx, None, t(p13), t(sf13), t(p2), t(sf2),
        num_experts=e, top_k=top_k, intermediate_size=inter,
        backend=backend)
    _close(got, want)
    np.testing.assert_allclose(
        moe._dequant_mxfp4(t(p13), t(sf13)).float().numpy(),
        np.asarray(jax_fp4.fp4_dequantize(p13, sf13, sf_vec_size=32,
                                          sf_use_ue8m0=True)),
        rtol=1e-6, atol=1e-6)


def test_entry_points_are_exported():
    import flashinfer_tpu_torch

    for name in jax_moe.__all__:
        assert name in moe.__all__, name
        assert getattr(flashinfer_tpu_torch.fused_moe, name) is getattr(
            moe, name)
