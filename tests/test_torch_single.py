"""Single-request attention: the port's ``flash_attention_dense`` (plain
version of the CUDA kernel on the CPU), ``single_prefill/decode_with_kv_cache``,
the oracle, bit packing and state merging, against the JAX package on the
same numpy inputs (JAX's flash kernel in Pallas interpret mode).

Tolerances: f32 o and lse within 2e-5 (sums in other orders). bf16 o within
2^-6 |ref| + 2^-8 and lse within 1e-3: both round P to bf16 before P.V,
JAX against each 128-key tile's running maximum and the plain version
against the row's global maximum."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops import quantization as jax_quant
from flashinfer_tpu.ops.attention import reference as jax_reference
from flashinfer_tpu.ops.attention import single as jax_single
from flashinfer_tpu.ops.attention import state as jax_state
from flashinfer_tpu.ops.attention import variants as jax_variants
from flashinfer_tpu.ops.attention.kernels.flash import (
    flash_attention_dense as jax_flash,
)
from flashinfer_tpu_torch.ops import quantization
from flashinfer_tpu_torch.ops.attention import single, state, variants
from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_dense,
    flash_num_splits,
)
from flashinfer_tpu_torch.ops.attention.reference import attention_reference

F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_LSE = 2.0 ** -6, 2.0 ** -8, 1e-3


def _both(x, dtype="f32"):
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _check(got, got_lse, want, want_lse, dtype="f32"):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "bf16":
        assert np.all(np.abs(got - want)
                      <= BF16_RTOL * np.abs(want) + BF16_ATOL)
        lse_tol = BF16_LSE
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        lse_tol = F32_TOL
    if got_lse is not None:
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=lse_tol, rtol=lse_tol)


def _qkv(rng, qo, kv, hq, hkv, d, dv, dtype="f32"):
    q = rng.standard_normal((qo, hq, d)).astype(np.float32)
    k = rng.standard_normal((kv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((kv, hkv, dv)).astype(np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


# name: (qo, kv, hq, hkv, d, dv, dtype, causal, window)
FLASH_CASES = {
    "causal_qo_lt_kv": (12, 40, 4, 2, 32, 32, "f32", True, -1),
    "window": (24, 40, 4, 2, 32, 32, "f32", True, 9),
    "soft_cap": (16, 30, 4, 2, 32, 32, "f32", True, -1),
    "alibi": (12, 33, 4, 2, 32, 32, "f32", True, -1),
    "sink": (12, 40, 4, 2, 32, 32, "f32", True, -1),
    "sigmoid": (10, 20, 4, 2, 32, 32, "f32", False, -1),
    "custom_mask": (9, 21, 4, 2, 32, 32, "f32", False, -1),
    "gqa_dv_ne_d": (8, 50, 8, 2, 32, 16, "f32", False, -1),
    "bf16": (16, 48, 4, 2, 32, 32, "bf16", True, -1),
    "bf16_window_sink": (16, 48, 4, 1, 32, 32, "bf16", True, 5),
    # a variant's sink_logits hook: the oracle's; both kernels ignore it
    "sink_hook": (12, 40, 4, 2, 32, 32, "f32", True, -1),
    # DeepSeek-V2-Lite's MHA shape: d 192 (nope 128 + rope 64), dv 128,
    # group 1 (each q head its own kv head)
    "d192_group1": (10, 30, 2, 2, 192, 128, "bf16", True, -1),
    "group1": (12, 40, 3, 3, 32, 32, "f32", True, -1),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_dense_matches_jax(name):
    qo, kv, hq, hkv, d, dv, dtype, causal, window = FLASH_CASES[name]
    rng = np.random.default_rng(list(FLASH_CASES).index(name))
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, qo, kv, hq, hkv, d, dv, dtype)
    jkw = dict(causal=causal, window_left=window)
    tkw = dict(causal=causal, window_left=window)
    if name == "soft_cap":
        jkw["variant"] = jax_variants.make_default_variant(logits_soft_cap=2.)
        tkw["variant"] = variants.make_default_variant(logits_soft_cap=2.)
    elif name == "alibi":
        slopes = single.default_alibi_slopes(hq, device="cpu").numpy()
        jkw["variant"] = jax_variants.make_default_variant(use_alibi=True)
        tkw["variant"] = variants.make_default_variant(use_alibi=True)
        jkw["variant_params"] = {"alibi_slopes": jnp.asarray(slopes)}
        tkw["variant_params"] = {"alibi_slopes": torch.from_numpy(slopes)}
    elif name.endswith("sink"):
        sink = (rng.standard_normal(hq) * 2).astype(np.float32)
        jkw["sink"], tkw["sink"] = _both(sink)
    elif name == "sink_hook":
        sink = (rng.standard_normal(hq) * 2).astype(np.float32)
        jkw["variant"] = jax_variants.make_default_variant(has_sink=True)
        tkw["variant"] = variants.make_default_variant(has_sink=True)
        jkw["variant_params"] = {"sink": jnp.asarray(sink)}
        tkw["variant_params"] = {"sink": torch.from_numpy(sink)}
    elif name == "sigmoid":
        jkw["variant"] = jax_variants.FlashSigmoid(0.5, -1.0)
        tkw["variant"] = variants.FlashSigmoid(0.5, -1.0)
    elif name == "custom_mask":
        mask = rng.random((qo, kv)) < 0.6
        mask[3] = False  # a row that sees no key
        jkw["custom_mask"], tkw["custom_mask"] = _both(mask)
    want, want_lse = jax_flash(jq, jk, jv, interpret=True, **jkw)
    got, got_lse = flash_attention_dense(tq, tk, tv, **tkw)
    assert got.dtype == tq.dtype and got.shape == (qo, hq, dv)
    _check(got, got_lse, want, want_lse, dtype)
    if name == "custom_mask":
        assert torch.isneginf(got_lse[3]).all() and not got[3].any()
        # the packed form gives the same result
        packed = quantization.packbits(torch.from_numpy(mask).reshape(-1))
        got2, lse2 = flash_attention_dense(tq, tk, tv, causal=causal,
                                           custom_mask=packed)
        torch.testing.assert_close(got2, got, atol=0, rtol=0)


def test_hooks_of_the_callers_own_run_in_the_plain_version():
    """A variant built from hooks (query and output transforms, a logits
    mask) runs in the plain version and agrees with JAX's oracle."""
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 10, 24, 4, 2, 32, 32)
    scale = rng.random(4).astype(np.float32) + 0.5

    def make(mod):
        return mod.AttentionVariant(
            name="custom",
            query_transform=lambda p, q: q * 1.5,
            logits_mask=lambda p, qp, kp, h: (kp + h) % 3 != 0,
            output_transform=lambda p, o: o * p["scale"][None, :, None],
            logits_transform=lambda p, s, qp, kp, h: s - 0.01 * (qp - kp))

    jvar, tvar = make(jax_variants), make(variants)
    assert tvar.kernel is None  # runs only in the plain version
    want, want_lse = jax_reference.attention_reference(
        jq, jk, jv, causal=True, variant=jvar,
        variant_params={"scale": jnp.asarray(scale)})
    got, got_lse = flash_attention_dense(
        tq, tk, tv, causal=True, variant=tvar,
        variant_params={"scale": torch.from_numpy(scale)})
    _check(got, got_lse, want, want_lse)


@pytest.mark.parametrize("mode", ["NONE", "ALIBI", "ROPE_LLAMA"])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_single_prefill_matches_jax(mode, layout):
    rng = np.random.default_rng([len(mode), layout == "HND"])
    qo, kv, hq, hkv, d = 11, 29, 4, 2, 32
    q = rng.standard_normal((qo, hq, d)).astype(np.float32)
    shape = (hkv, kv, d) if layout == "HND" else (kv, hkv, d)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random((qo, kv)) < 0.7
    packed = np.packbits(mask.reshape(-1))
    kw = dict(kv_layout=layout, pos_encoding_mode=mode, causal=True,
              return_lse=True)
    if mode == "NONE":
        kw["logits_soft_cap"] = 3.0
    want, want_lse = jax_single.single_prefill_with_kv_cache(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        packed_custom_mask=jnp.asarray(packed), backend="pallas", **kw)
    got, got_lse = single.single_prefill_with_kv_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        packed_custom_mask=torch.from_numpy(packed), **kw)
    _check(got, got_lse, want, want_lse)
    ref, ref_lse = single.single_prefill_with_kv_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        packed_custom_mask=torch.from_numpy(packed), backend="reference",
        **kw)
    _check(ref, ref_lse, want, want_lse)


@pytest.mark.parametrize("mode", ["NONE", "ALIBI", "ROPE_LLAMA"])
def test_single_decode_matches_jax(mode):
    rng = np.random.default_rng(len(mode) + 7)
    hq, hkv, d, kv = 8, 2, 32, 37
    q = rng.standard_normal((hq, d)).astype(np.float32)
    k = rng.standard_normal((kv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((kv, hkv, d)).astype(np.float32)
    want, want_lse = jax_single.single_decode_with_kv_cache(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        pos_encoding_mode=mode, window_left=20, return_lse=True,
        backend="pallas")
    got, got_lse = single.single_decode_with_kv_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pos_encoding_mode=mode, window_left=20, return_lse=True)
    assert got.shape == (hq, d) and got_lse.shape == (hq,)
    _check(got, got_lse, want, want_lse)
    got_o = single.single_decode_with_kv_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pos_encoding_mode=mode, window_left=20)
    torch.testing.assert_close(got_o, got, atol=0, rtol=0)


def test_single_backends():
    q, k, v = (torch.zeros(2, 2, 16) for _ in range(3))
    with pytest.raises(ValueError, match="pallas"):
        single.single_prefill_with_kv_cache(q, k, v, backend="pallas")
    torch.testing.assert_close(single.default_alibi_slopes(12, device="cpu"),
                               torch.from_numpy(np.array(
                                   jax_single.default_alibi_slopes(12))))


def test_attention_reference_full_oracle_matches_jax():
    rng = np.random.default_rng(21)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 9, 20, 4, 2, 16, 16)
    mask = rng.random((9, 20)) < 0.7
    slopes = rng.random(4).astype(np.float32)
    sink = rng.standard_normal(4).astype(np.float32)
    kw_j = dict(causal=True, custom_mask=jnp.asarray(mask),
                alibi_slopes=jnp.asarray(slopes), sink=jnp.asarray(sink))
    kw_t = dict(causal=True, custom_mask=torch.from_numpy(mask),
                alibi_slopes=torch.from_numpy(slopes),
                sink=torch.from_numpy(sink))
    want, want_lse = jax_reference.attention_reference(jq, jk, jv, **kw_j)
    got, got_lse = attention_reference(tq, tk, tv, **kw_t)
    _check(got, got_lse, want, want_lse)
    # sigmoid: no softmax, lse 0
    want, want_lse = jax_reference.attention_reference(
        jq, jk, jv, variant=jax_variants.FlashSigmoid(2.0, 0.5))
    got, got_lse = attention_reference(tq, tk, tv,
                                       variant=variants.FlashSigmoid(2.0, 0.5))
    _check(got, got_lse, want, want_lse)
    assert not got_lse.any()
    # the soft cap argument is applied (JAX's oracle takes it from the
    # variant only)
    want, _ = jax_reference.attention_reference(
        jq, jk, jv, variant=jax_variants.make_default_variant(
            logits_soft_cap=1.5))
    got, _ = attention_reference(tq, tk, tv, logits_soft_cap=1.5)
    _check(got, None, want, None)


@pytest.mark.parametrize("bitorder", ["big", "little"])
def test_packbits_matches_jax(bitorder):
    rng = np.random.default_rng(3)
    x = rng.random(53) < 0.5
    want = np.asarray(jax_quant.packbits(jnp.asarray(x), bitorder))
    got = quantization.packbits(torch.from_numpy(x), bitorder)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        quantization.unpackbits(got, 53, bitorder).numpy(),
        np.asarray(jax_quant.unpackbits(jnp.asarray(want), 53, bitorder)))
    indptr = np.asarray([0, 5, 5, 30, 53])
    wp, wi = jax_quant.segment_packbits(jnp.asarray(x), jnp.asarray(indptr),
                                        bitorder)
    gp, gi = quantization.segment_packbits(torch.from_numpy(x), indptr,
                                           bitorder)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_merge_states_match_jax():
    rng = np.random.default_rng(8)
    v = rng.standard_normal((5, 3, 4, 16)).astype(np.float32)
    s = rng.standard_normal((5, 3, 4)).astype(np.float32)
    s[0] = -np.inf  # a row with no state at all
    s[1, 1] = -np.inf
    want_v, want_s = jax_state.merge_states(jnp.asarray(v), jnp.asarray(s))
    got_v, got_s = state.merge_states(torch.from_numpy(v), torch.from_numpy(s))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=F32_TOL)
    want_v, want_s = jax_state.merge_state(*(jnp.asarray(x) for x in (
        v[:, 0], s[:, 0], v[:, 1], s[:, 1])))
    got_v, got_s = state.merge_state(*(torch.from_numpy(x) for x in (
        v[:, 0], s[:, 0], v[:, 1], s[:, 1])))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=F32_TOL)


def test_split_kv_merge_equals_one_pass():
    """The kernel's split-KV path in plain terms: attention over key ranges
    merged with ``merge_states`` (and the sink as one more state) equals
    one pass over all keys. Also the split count the wrapper picks."""
    rng = np.random.default_rng(9)
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 1, 300, 8, 2, 32, 32)
    sink = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    want, want_lse = flash_attention_dense(tq, tk, tv, sink=sink)
    parts = [flash_attention_dense(tq, tk[a:b], tv[a:b])
             for a, b in ((0, 64), (64, 256), (256, 300))]
    o = torch.stack([p[0] for p in parts], 1)
    s = torch.stack([p[1] for p in parts], 1)
    o, s = state.merge_states(o, s)
    o, s = state.merge_state(o, s, torch.zeros_like(o), sink[None])
    torch.testing.assert_close(o, want, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(s, want_lse, atol=F32_TOL, rtol=F32_TOL)
    # Llama-3-8B heads on 132 SMs: decode splits to fill the card once (8
    # kv heads x 16 splits, one bf16 CTA an SM; f32 two), prefill does not
    assert flash_num_splits(1, 32768, 32, 8, torch.bfloat16, 132) == 16
    assert flash_num_splits(1, 32768, 32, 8, torch.float32, 132) == 33
    assert flash_num_splits(8192, 8192, 32, 8, torch.bfloat16, 132) == 1
    assert flash_num_splits(1, 100, 32, 8, torch.bfloat16, 132) == 1
    # 64-key tiles where dv 256 does not fit 128: at least 4 tiles a split
    assert flash_num_splits(1, 1024, 32, 8, torch.bfloat16, 132, 256) == 4
    assert flash_num_splits(1, 1024, 32, 8, torch.bfloat16, 132, 128) == 2


def test_sigmoid_plain_version_within_the_bf16_limit_of_float64():
    """With sigmoid attention's bias -log(n) each row's weights sum to about
    1 (a unit-size P.V sum, what the bf16 o limit is set for), and the
    plain version in f32 stays within that limit of a float64 evaluation
    whose weights are rounded to bf16 as the function rounds P."""
    rng = np.random.default_rng(12)
    qo = kv = 2048
    hq, d = 4, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((n, h, d)).astype(
        np.float32)).bfloat16() for n, h in ((qo, hq), (kv, 1), (kv, 1)))
    bias = -math.log(kv)
    got, _ = flash_attention_dense(q, k, v, causal=True,
                                   variant=variants.FlashSigmoid(1.0, bias))
    s = torch.einsum("qhd,kd->hqk", q.double(), k[:, 0].double()) * d ** -0.5
    w = torch.sigmoid(s + bias)
    w = torch.where(torch.ones(qo, kv, dtype=torch.bool).tril(), w, 0.0)
    assert 0.5 < float(w.sum(-1).max()) < 4  # unit-size sums
    want = torch.einsum("hqk,kd->qhd", w.bfloat16().double(),
                        v[:, 0].double())
    limit = BF16_RTOL * want.abs() + BF16_ATOL
    assert bool(((got.double() - want).abs() <= limit).all())
