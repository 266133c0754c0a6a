"""Routing, the grouped GEMM and fused MoE: the port (plain versions of the
kernels on the CPU) against the JAX package, the Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances: expert ids exact and routing scales to 1e-6 (softmax and
sigmoid in f32, other summation orders); layouts exact; the bf16 grouped
GEMM to 1e-5 relative of an f32 output (products of bf16 values are exact
in f32; only the order of the f32 sums differs) and one bf16 step when the
output is bf16; fused MoE in bf16 to one bf16 step of its intermediates
(x, h1 and the activation are rounded to bf16 on both sides, and a sum
that lands on a rounding boundary can round the other way: 2e-2
relative), in f32 to 1e-5."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models.deepseek import DeepSeekConfig as JaxDeepSeekConfig

# the packages export functions of the same names as these modules
jax_moe = importlib.import_module("flashinfer_tpu.ops.fused_moe")
jax_gg = importlib.import_module("flashinfer_tpu.ops.gemm_grouped")
moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")
gg = importlib.import_module("flashinfer_tpu_torch.ops.gemm_grouped")


def _bf16(x):
    """numpy f32 -> (the jnp bf16 array, the same values as a torch bf16
    tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("method", list(moe.RoutingMethodType))
def test_route_tokens_matches_jax(method):
    rng = np.random.default_rng(int(method))
    m, e = 12, 16
    logits = rng.standard_normal((m, e)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(e)).astype(np.float32)
    top_k = 1 if method == moe.RoutingMethodType.Llama4 else 4
    kw = dict(n_group=4, topk_group=2, routed_scaling_factor=2.5)
    jid, jsc = jax_moe.route_tokens(
        jnp.asarray(logits), top_k, jax_moe.RoutingMethodType(int(method)),
        routing_bias=jnp.asarray(bias), **kw)
    tid, tsc = moe.route_tokens(torch.from_numpy(logits), top_k, method,
                                routing_bias=torch.from_numpy(bias), **kw)
    assert tid.dtype == torch.int32
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("gs,tm", [([70, 0, 130, 56], 128), ([256, 0, 0, 0],
                                   64), ([1, 1, 1, 1], 16), ([0, 0, 0, 0], 16),
                                   ([5, 0, 131, 12], 64)])
def test_make_group_layout_matches_jax(gs, tm):
    gs = np.asarray(gs, np.int32)
    n = int(gs.sum())
    want = jax_gg.make_group_layout(jnp.asarray(gs), n, tm)
    got = gg.make_group_layout(torch.from_numpy(gs), n, tm)
    assert got.m_pad == want.m_pad and got.tm == tm
    for name in ("expert_of_tile", "src_row", "src_valid", "padded_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def _layout_and_rows(rng, gs, K, tm):
    gs = np.asarray(gs, np.int32)
    n = int(gs.sum())
    lay = jax_gg.make_group_layout(jnp.asarray(gs), n, tm)
    x = rng.standard_normal((n, K)).astype(np.float32)
    src = np.asarray(lay.src_row)
    x_pad = np.where(np.asarray(lay.src_valid)[:, None], x[src], 0)
    return lay, x_pad.astype(np.float32)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_grouped_gemm_bf16_matches_jax(out):
    rng = np.random.default_rng(0)
    E, K, N, tm = 4, 256, 256, 128
    lay, x_pad = _layout_and_rows(rng, [70, 0, 130, 56], K, tm)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    jx, tx = _bf16(x_pad)
    jw, tw = _bf16(w)
    jdt, tdt = ((jnp.float32, torch.float32) if out == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_gg.grouped_gemm_padded(jx, jw, lay.expert_of_tile,
                                      out_dtype=jdt, interpret=True)
    eot = torch.from_numpy(np.asarray(lay.expert_of_tile))
    got = gg.grouped_gemm_padded(tx, tw, eot, out_dtype=tdt)
    want = np.asarray(want.astype(jnp.float32))
    if out == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        # one bf16 step: the f32 sums may straddle a rounding boundary
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(want).max())
    # the weights in their [E, N, K] layout give the same rows
    nk = gg.grouped_gemm_padded(tx, tw.transpose(1, 2).contiguous(), eot,
                                out_dtype=tdt, rhs_nk=True)
    torch.testing.assert_close(nk, got, rtol=0, atol=0)


def test_grouped_gemm_e4m3_matches_jax():
    """e4m3 weights with a per-expert scale. The JAX kernel's bit decode
    wants the rows K-permuted (fp8_k_permutation), on its side only; the
    port reads e4m3 in hardware order. The weights avoid e4m3 denormals,
    which the JAX bit decode approximates (ROADMAP Queue 3), so both sides
    see the same values."""
    rng = np.random.default_rng(1)
    E, K, N, tm, tk = 4, 256, 256, 128, 256
    lay, x_pad = _layout_and_rows(rng, [100, 28, 0, 128], K, tm)
    q = rng.standard_normal((E, K, N)).astype(np.float32)
    q = np.sign(q) * np.maximum(np.abs(q), 2.0 ** -5)
    scales = np.array([0.2, 0.31, 0.15, 0.27], np.float32)
    bits = torch.from_numpy(q).to(torch.float8_e4m3fn)
    jx, tx = _bf16(x_pad)
    want = jax_gg.grouped_gemm_padded(
        jx[:, jax_gg.fp8_k_permutation(K, tk)],
        jnp.asarray(bits.view(torch.int8).numpy()), lay.expert_of_tile,
        jnp.asarray(scales), tk=tk, out_dtype=jnp.float32, interpret=True)
    eot = torch.from_numpy(np.asarray(lay.expert_of_tile))
    got = gg.grouped_gemm_padded(tx, bits, eot, torch.from_numpy(scales),
                                 out_dtype=torch.float32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert not got[np.asarray(lay.expert_of_tile).repeat(tm) < 0].any()


def test_grouped_gemm_ragged_matches_jax():
    rng = np.random.default_rng(2)
    E, K, N = 4, 256, 384
    gs = np.asarray([70, 0, 130, 56], np.int32)
    x = rng.standard_normal((int(gs.sum()), K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    jx, tx = _bf16(x)
    jw, tw = _bf16(w)
    want = jax_gg.grouped_gemm(jx, jw, jnp.asarray(gs), tm=128,
                               out_dtype=jnp.float32, interpret=True)
    got = gg.grouped_gemm(tx, tw, torch.from_numpy(gs), tm=64,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def _moe_inputs(rng, m, e, hidden, inter, top_k):
    x = rng.standard_normal((m, hidden)).astype(np.float32)
    w13 = (rng.standard_normal((e, 2 * inter, hidden)) * 0.1).astype(
        np.float32)
    w2 = (rng.standard_normal((e, hidden, inter)) * 0.1).astype(np.float32)
    logits = rng.standard_normal((m, e)).astype(np.float32)
    return x, w13, w2, logits


@pytest.mark.parametrize("act", list(moe.GatedActType))
def test_fused_moe_bf16_matches_jax_pallas(act):
    rng = np.random.default_rng(3 + int(act))
    m, e, hidden, inter, top_k = 16, 4, 128, 128, 2
    x, w13, w2, logits = _moe_inputs(rng, m, e, hidden, inter, top_k)
    ids, sc = jax_moe.route_tokens(jnp.asarray(logits), top_k)
    (jx, tx), (j13, t13), (j2, t2) = _bf16(x), _bf16(w13), _bf16(w2)
    want = jax_moe.fused_moe(jx, j13, j2, ids, sc, backend="pallas",
                             interpret=True,
                             gated_act=jax_moe.GatedActType(int(act)))
    got = moe.fused_moe(tx, t13, t2, torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(sc)), gated_act=act)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def test_fused_moe_e4m3_matches_jax_pallas():
    rng = np.random.default_rng(5)
    m, e, hidden, inter, top_k = 24, 4, 128, 128, 2
    x, w13, w2, logits = _moe_inputs(rng, m, e, hidden, inter, top_k)
    s13, s2 = np.full(e, 0.02, np.float32), np.full(e, 0.03, np.float32)
    b13 = torch.from_numpy(w13 / s13[:, None, None]).to(torch.float8_e4m3fn)
    b2 = torch.from_numpy(w2 / s2[:, None, None]).to(torch.float8_e4m3fn)
    ids, sc = jax_moe.route_tokens(jnp.asarray(logits), top_k)
    jx, tx = _bf16(x)
    want = jax_moe.fused_moe(
        jx, jnp.asarray(b13.view(torch.int8).numpy()),
        jnp.asarray(b2.view(torch.int8).numpy()), ids, sc,
        w13_scale=jnp.asarray(s13), w2_scale=jnp.asarray(s2),
        backend="pallas", interpret=True, out_dtype=jnp.float32)
    got = moe.fused_moe(tx, b13, b2, torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(sc)),
                        w13_scale=torch.from_numpy(s13),
                        w2_scale=torch.from_numpy(s2),
                        out_dtype=torch.float32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def test_fused_moe_f32_matches_jax_xla_tiny_deepseek():
    """The f32 route against JAX's ragged_dot path at the widths of
    DeepSeekConfig.tiny() (not 128-divisible, so JAX takes XLA there)."""
    cfg = JaxDeepSeekConfig.tiny()
    rng = np.random.default_rng(6)
    m = 10
    x, w13, w2, logits = _moe_inputs(rng, m, cfg.num_experts,
                                     cfg.hidden_size, cfg.moe_inter_size,
                                     cfg.top_k)
    ids, sc = jax_moe.route_tokens(
        jnp.asarray(logits), cfg.top_k, jax_moe.RoutingMethodType.DeepSeekV3,
        n_group=cfg.n_group, topk_group=cfg.topk_group)
    want = jax_moe.fused_moe(jnp.asarray(x), jnp.asarray(w13),
                             jnp.asarray(w2), ids, sc, backend="xla")
    got = moe.fused_moe(torch.from_numpy(x), torch.from_numpy(w13),
                        torch.from_numpy(w2),
                        torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(sc)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_moe_backend_names():
    x = torch.zeros(2, 16)
    w13, w2 = torch.zeros(2, 32, 16), torch.zeros(2, 16, 16)
    ids = torch.zeros(2, 1, dtype=torch.int32)
    sc = torch.ones(2, 1)
    for backend in ("auto", "pallas", "xla"):
        assert moe.fused_moe(x, w13, w2, ids, sc, backend=backend).shape == (
            2, 16)
    with pytest.raises(ValueError, match="backend"):
        moe.fused_moe(x, w13, w2, ids, sc, backend="cutlass")


@pytest.mark.parametrize("m,e,top_k", [(8, 64, 6), (40, 8, 2), (3, 16, 4)])
def test_permute_by_expert_matches_jax(m, e, top_k):
    """The stable order and the group sizes (counted with an index_add,
    which a CUDA graph can capture, where JAX uses bincount), an expert
    with no pairs included."""
    rng = np.random.default_rng(m * e)
    ids = rng.integers(0, e - 1, (m, top_k)).astype(np.int32)  # e-1 unused
    jorder, jgs = jax_moe._permute_by_expert(jnp.asarray(ids), e)
    torder, tgs = moe._permute_by_expert(torch.from_numpy(ids), e)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tgs.numpy(), np.asarray(jgs))
    assert tgs.shape == (e,) and int(tgs[e - 1]) == 0


@pytest.mark.parametrize("rows,experts,tm", [
    (48, 64, 16),      # V2-Lite decode: 8 tokens x top-6 of 64
    (96, 4, 32),
    (12288, 64, 128),  # V2-Lite prefill: 2048 tokens, ~190 rows an expert
    (6000, 64, 64),    # ~94 rows an expert
    (8192, 8, 128),    # a Mixtral-8x7B layer: 4096 tokens x top-2 of 8
])
def test_select_moe_tm(rows, experts, tm):
    assert moe.select_moe_tm(rows, experts) == tm


def _ragged_case(case, rng):
    """(x, w13, w2, scales of w13 and w2, logits) as numpy for the calls the
    grouped-GEMM kernel cannot take: K 96 / N 200 in bf16 (GEMM 2 then has
    K 100), and e4m3 weights with one scale a weight row (per channel)."""
    if case == "k96_n200_bf16":
        m, e, hidden, inter, top_k = 12, 4, 96, 100, 2
        x, w13, w2, logits = _moe_inputs(rng, m, e, hidden, inter, top_k)
        return x, w13, w2, None, None, logits, top_k
    m, e, hidden, inter, top_k = 12, 4, 128, 128, 2
    x, w13, w2, logits = _moe_inputs(rng, m, e, hidden, inter, top_k)
    s13 = (0.01 + 0.02 * rng.random((e, 2 * inter, 1))).astype(np.float32)
    s2 = (0.01 + 0.02 * rng.random((e, hidden, 1))).astype(np.float32)
    return x, w13 / s13, w2 / s2, s13, s2, logits, top_k


@pytest.mark.parametrize("case", ["k96_n200_bf16", "per_channel_e4m3"])
def test_fused_moe_ragged_route_matches_jax_xla(case):
    """Calls the grouped-GEMM kernel cannot take run the ragged_dot route,
    held to JAX's backend="xla" (the route JAX gives them), and
    backend="pallas" refuses them as JAX's does."""
    rng = np.random.default_rng(11)
    x, w13, w2, s13, s2, logits, top_k = _ragged_case(case, rng)
    ids, sc = jax_moe.route_tokens(jnp.asarray(logits), top_k)
    jx, tx = _bf16(x)
    if s13 is None:
        (j13, t13), (j2, t2) = _bf16(w13), _bf16(w2)
        kw_j, kw_t = {}, {}
    else:
        t13, t2 = (torch.from_numpy(w).to(torch.float8_e4m3fn)
                   for w in (w13, w2))
        j13, j2 = (jnp.asarray(t.view(torch.int8).numpy()) for t in (t13, t2))
        kw_j = dict(w13_scale=jnp.asarray(s13), w2_scale=jnp.asarray(s2))
        kw_t = dict(w13_scale=torch.from_numpy(s13),
                    w2_scale=torch.from_numpy(s2))
    assert not moe._kernel_takes(t13, t2, kw_t.get("w13_scale"),
                                 kw_t.get("w2_scale"))
    want = jax_moe.fused_moe(jx, j13, j2, ids, sc, backend="xla",
                             out_dtype=jnp.float32, **kw_j)
    tids, tsc = (torch.from_numpy(np.asarray(a)) for a in (ids, sc))
    got = moe.fused_moe(tx, t13, t2, tids, tsc, out_dtype=torch.float32,
                        **kw_t)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())
    with pytest.raises(ValueError, match="pallas"):
        moe.fused_moe(tx, t13, t2, tids, tsc, backend="pallas", **kw_t)
