"""The port's fp8 / fp4 / GEMM op surface against the JAX package on the
same inputs (mirroring tests/test_gemm_quant.py), and the dense 8-bit
matmul ``w8_matmul`` (its plain version, the CPU route) against JAX's
``_wmm``.

Tolerances, by what each side computes:
- decodes, quantizers and packed bytes: exact (integer decodes, the same
  f32 divides and roundings); mxfp8's dequantized values 1e-6 relative
  (XLA's exp2 on the CPU is a few ulp off a power of two);
- f32 products: 1e-5 relative plus 1e-5 of the output's largest value
  (f32 sums in other orders);
- bf16 outputs of f32 products: one bf16 step, 2^-7 relative, plus 1e-5 of
  the largest value (a sum that lands near a rounding boundary rounds the
  other way);
- ``w8_matmul`` in bf16: the product is rounded to bf16 before the scale on
  both sides (JAX's order), so the same one step; in f32, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops import activation as jax_act
from flashinfer_tpu.ops import fp4 as jax_fp4
from flashinfer_tpu.ops import fp8 as jax_fp8
from flashinfer_tpu.ops import gemm as jax_gemm
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.ops import activation as torch_act
from flashinfer_tpu_torch.ops import fp4 as torch_fp4
from flashinfer_tpu_torch.ops import fp8 as torch_fp8
from flashinfer_tpu_torch.ops import gemm as torch_gemm
from flashinfer_tpu_torch.ops.gemm_grouped import (
    grouped_gemm_padded,
    w8_matmul,
    w8_matmul_plain,
)
from flashinfer_tpu_torch.utils import tensor_from_numpy

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    """A JAX array or numpy array as a CPU tensor, bits kept."""
    return tensor_from_numpy(np.asarray(a), CPU)


def _u8(t) -> np.ndarray:
    """The bytes of an 8-bit tensor or array as uint8."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.int8):
            t = t.view(torch.uint8)
        return t.numpy()
    return np.asarray(t).view(np.uint8)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------- ops/fp8

def test_e4m3_bits_to_bf16_every_code_equals_jax():
    """All 256 codes, denormals (flushed to +-0) and NaN (+-480) too."""
    codes = np.arange(256, dtype=np.uint8).view(np.int8)
    want = jax_fp8.e4m3_bits_to_bf16(jnp.asarray(codes))
    got = torch_fp8.e4m3_bits_to_bf16(torch.from_numpy(codes))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert float(got[0x7F]) == 480.0 and float(got[0xFF]) == -480.0
    assert float(got[0x01]) == 0.0 and float(got[0x07]) == 0.0


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "int8", "float32",
                                   "bfloat16"])
def test_fp8_to_bf16_equals_jax(dtype):
    codes = np.arange(256, dtype=np.uint8)
    if dtype == "float8_e4m3fn":
        x = jnp.asarray(codes).view(jnp.float8_e4m3fn)
    elif dtype == "int8":
        x = jnp.asarray(codes.view(np.int8))
    else:
        x = jnp.asarray(_rows(1, (4, 64), 3.0), dtype)
    want = jax_fp8.fp8_to_bf16(x)
    got = torch_fp8.fp8_to_bf16(_t(x))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_mxfp8_quantize_and_dequantize_equal_jax():
    """Blocks spanning 2^-20 to 2^12, one block all zeros, one at 448's
    exact power-of-two edge."""
    x = _rows(2, (6, 128))
    x *= np.exp2(np.arange(-20, 12, 32 / 6))[:, None].astype(np.float32)
    x[1, :32] = 0.0
    x[2, 32:64] = 0.0
    x[2, 40] = 448.0 * 4
    wq, wsf = jax_fp8.mxfp8_quantize(jnp.asarray(x))
    q, sf = torch_fp8.mxfp8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.float8_e4m3fn and sf.dtype == torch.uint8
    np.testing.assert_array_equal(_u8(q), _u8(wq))
    np.testing.assert_array_equal(sf.numpy(), np.asarray(wsf))
    # XLA's exp2 on the CPU lands a few ulp off the power of two that
    # torch.exp2 gives exactly: 1e-6 relative
    np.testing.assert_allclose(
        torch_fp8.mxfp8_dequantize(q, sf).numpy(),
        np.asarray(jax_fp8.mxfp8_dequantize(wq, wsf)), rtol=1e-6, atol=0)


def test_fp8_quantize_rowwise_equals_jax():
    """Every row's amax lands on 448 itself."""
    x = _rows(3, (8, 96), 5.0)
    wq, ws = jax_fp8.fp8_quantize_rowwise(jnp.asarray(x))
    q, s = torch_fp8.fp8_quantize_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(_u8(q), _u8(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert (np.abs(q.float().numpy()).max(axis=-1) == 448.0).all()


# ---------------------------------------------------------------- ops/fp4

def test_e2m1_codes_equal_jax():
    codes = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(
        torch_fp4.e2m1_to_float(torch.from_numpy(codes)).numpy(),
        np.asarray(jax_fp4.e2m1_to_float(jnp.asarray(codes))))


@pytest.mark.parametrize("sf_vec_size,ue8m0,global_scale", [
    (16, False, None), (16, False, 3.7), (32, True, None), (32, False, 0.25)])
def test_fp4_quantize_and_dequantize_equal_jax(sf_vec_size, ue8m0,
                                               global_scale):
    """Packed nibbles (low nibble the even index) and scales exact; values
    on the e2m1 midpoints round as JAX's bounds do."""
    x = _rows(4, (6, 128), 2.0)
    x[0, :8] = [0.25, 0.75, -1.25, 1.75, 2.5, -3.5, 5.0, 6.0]  # midpoints
    x[1, :sf_vec_size] = 0.0
    gs = None if global_scale is None else jnp.asarray(global_scale,
                                                       jnp.float32)
    wp, wsf = jax_fp4.fp4_quantize(jnp.asarray(x), gs, sf_vec_size, ue8m0)
    p, sf = torch_fp4.fp4_quantize(
        torch.from_numpy(x), None if gs is None else torch.tensor(
            global_scale), sf_vec_size, ue8m0)
    assert p.dtype == torch.uint8 and p.shape == (6, 64)
    np.testing.assert_array_equal(p.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(sf.numpy(), np.asarray(wsf))
    kw = dict(sf_vec_size=sf_vec_size, sf_use_ue8m0=ue8m0)
    want = jax_fp4.fp4_dequantize(wp, wsf, global_scale=gs, **kw)
    got = torch_fp4.fp4_dequantize(
        p, sf, global_scale=None if gs is None else torch.tensor(
            global_scale), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nvfp4_and_mxfp4_equal_jax():
    x = _rows(5, (4, 64), 3.0)
    gs = jnp.asarray(2.0, jnp.float32)
    for got, want in ((torch_fp4.nvfp4_quantize(torch.from_numpy(x),
                                                torch.tensor(2.0)),
                       jax_fp4.nvfp4_quantize(jnp.asarray(x), gs)),
                      (torch_fp4.mxfp4_quantize(torch.from_numpy(x)),
                       jax_fp4.mxfp4_quantize(jnp.asarray(x)))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    p, sf = torch_fp4.mxfp4_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(
        torch_fp4.mxfp4_dequantize(p, sf).numpy(),
        np.asarray(jax_fp4.mxfp4_dequantize(jnp.asarray(p.numpy()),
                                            jnp.asarray(sf.numpy()))))


def test_fp4_layout_helpers_are_identities():
    t = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    for fn in (torch_fp4.block_scale_interleave, torch_fp4.shuffle_matrix_a,
               torch_fp4.shuffle_matrix_sf_a):
        assert fn(t) is t
    assert [m.name for m in torch_fp4.SfLayout] == [
        m.name for m in jax_fp4.SfLayout]
    assert [m.value for m in torch_fp4.SfLayout] == [
        m.value for m in jax_fp4.SfLayout]


# --------------------------------------------------------------- ops/gemm

def test_bmm_fp8_equals_jax():
    a8 = jnp.asarray(_rows(6, (2, 4, 64)), jnp.float8_e4m3fn)
    b8 = jnp.asarray(_rows(7, (2, 64, 32)), jnp.float8_e4m3fn)
    want = jax_gemm.bmm_fp8(a8, b8, jnp.asarray(2.0), jnp.asarray(0.5))
    got = torch_gemm.bmm_fp8(_t(a8), _t(b8), torch.tensor(2.0),
                             torch.tensor(0.5))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2 ** -7)


def test_mm_fp4_equals_jax():
    a, b = _rows(8, (8, 64)), _rows(9, (16, 64))
    aq, asf = jax_fp4.fp4_quantize(jnp.asarray(a))
    bq, bsf = jax_fp4.fp4_quantize(jnp.asarray(b))
    for alpha in (None, 0.75):
        want = jax_gemm.mm_fp4(aq, bq, asf, bsf, alpha=alpha,
                               out_dtype=jnp.float32)
        got = torch_gemm.mm_fp4(_t(aq), _t(bq), _t(asf), _t(bsf),
                                alpha=alpha, out_dtype=torch.float32)
        _close(got, want, 1e-5)


def test_gemm_fp8_nt_groupwise_equals_jax():
    m, n, k = 32, 256, 384
    rng = np.random.default_rng(10)
    a8 = jnp.asarray(_rows(11, (m, k)), jnp.float8_e4m3fn)
    b8 = jnp.asarray(_rows(12, (n, k)), jnp.float8_e4m3fn)
    a_s = jnp.asarray(rng.uniform(0.5, 2.0, (m, k // 128)), jnp.float32)
    b_s = jnp.asarray(rng.uniform(0.5, 2.0, (k // 128, n // 128)),
                      jnp.float32)
    for out_dtype, tdt, rtol in ((jnp.float32, torch.float32, 1e-5),
                                 (jnp.bfloat16, torch.bfloat16, 2 ** -7)):
        want = jax_gemm.gemm_fp8_nt_groupwise(a8, b8, a_s, b_s,
                                              out_dtype=out_dtype,
                                              interpret=True)
        got = torch_gemm.gemm_fp8_nt_groupwise(_t(a8), _t(b8), _t(a_s),
                                               _t(b_s), out_dtype=tdt)
        _close(got, want, rtol)


def test_group_gemm_fp8_nt_groupwise_equals_jax():
    """Three groups, one empty, on the grouped GEMM's plain version."""
    g, n, k = 3, 64, 256
    rng = np.random.default_rng(13)
    m_indptr = np.asarray([0, 5, 5, 16])
    a = jnp.asarray(_rows(14, (16, k)), jnp.float8_e4m3fn)
    b = jnp.asarray(_rows(15, (g, n, k)), jnp.float8_e4m3fn)
    a_s = jnp.asarray(rng.uniform(0.5, 2, (16, k // 128)), jnp.float32)
    b_s = jnp.asarray(rng.uniform(0.5, 2, (g, k // 128, 1)), jnp.float32)
    want = jax_gemm.group_gemm_fp8_nt_groupwise(
        a, b, a_s, b_s, jnp.asarray(m_indptr), out_dtype=jnp.float32)
    got = torch_gemm.group_gemm_fp8_nt_groupwise(
        _t(a), _t(b), _t(a_s), _t(b_s), torch.from_numpy(m_indptr),
        out_dtype=torch.float32)
    _close(got, want, 1e-5)


def test_group_gemm_mxfp4_nt_groupwise_equals_jax():
    g, n, k = 2, 32, 256
    rng = np.random.default_rng(16)
    m_indptr = np.asarray([0, 7, 12])
    a = jnp.asarray(_rows(17, (12, k)), jnp.float8_e4m3fn)
    a_s = jnp.asarray(rng.uniform(0.5, 2, (12, k // 128)), jnp.float32)
    bq, bsf = jax_fp4.mxfp4_quantize(jnp.asarray(_rows(18, (g, n, k))))
    want = jax_gemm.group_gemm_mxfp4_nt_groupwise(
        a, bq, a_s, bsf, jnp.asarray(m_indptr))
    got = torch_gemm.group_gemm_mxfp4_nt_groupwise(
        _t(a), _t(bq), _t(a_s), _t(bsf), torch.from_numpy(m_indptr))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2 ** -7)


def test_tgv_gemm_equals_jax():
    a, b, bias = _rows(19, (4, 64)), _rows(20, (64, 48)), _rows(21, (48,))
    for bb in (None, bias):
        want = jax_gemm.tgv_gemm(jnp.asarray(a), jnp.asarray(b),
                                 None if bb is None else jnp.asarray(bb))
        got = torch_gemm.tgv_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                  None if bb is None else torch.from_numpy(bb))
        _close(got, want, 1e-5)


@pytest.mark.parametrize("column_major", [False, True])
@pytest.mark.parametrize("segments", ["lens", "indptr", "indices"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_gemm_equals_jax(column_major, segments, dtype):
    """Segments of 3, 0 and 7 rows (an empty one), by seg_lens, by
    seg_indptr, or by seg_indptr with weight_indices; ``forward`` is
    ``run``."""
    x = jnp.asarray(_rows(22, (10, 64)), dtype)
    w_shape = (3, 32, 64) if column_major else (3, 64, 32)
    w = jnp.asarray(_rows(23, w_shape, 0.2), dtype)
    kw = dict(seg_lens=np.asarray([3, 0, 7]))
    if segments != "lens":
        kw = dict(seg_indptr=np.asarray([0, 3, 3, 10]))
    if segments == "indices":
        kw["weight_indices"] = np.asarray([2, 0, 1])
    want = jax_gemm.SegmentGEMMWrapper().run(
        x, w, 3, column_major, **{k: jnp.asarray(v) for k, v in kw.items()})
    wrapper = torch_gemm.SegmentGEMMWrapper()
    assert wrapper.forward == wrapper.run
    got = wrapper.run(_t(x), _t(w), 3, column_major,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == _t(x).dtype
    _close(got, want, 1e-5 if dtype == "float32" else 2 ** -7)


def test_silu_and_mul_nvfp4_batched_quantize_equals_jax():
    """f32 rows, a mask that drops one row of each batch: the masked rows
    quantize to zero codes; every other code and scale equals JAX's where
    the two f32 sigmoids agree to the bit (all but a few values)."""
    a = _rows(24, (2, 5, 128), 2.0)
    mask = np.ones((2, 5), np.int32)
    mask[0, 1] = mask[1, 4] = 0
    wp, wsf = jax_act.silu_and_mul_nvfp4_batched_quantize(
        jnp.asarray(a), jnp.asarray(mask), jnp.asarray([1.5], jnp.float32))
    p, sf = torch_act.silu_and_mul_nvfp4_batched_quantize(
        torch.from_numpy(a), torch.from_numpy(mask), torch.tensor([1.5]))
    assert p.shape == (2, 5, 32) and sf.shape == (2, 5, 4)
    assert not p[0, 1].any() and not p[1, 4].any()
    np.testing.assert_array_equal(sf.numpy(), np.asarray(wsf))
    assert float(np.mean(p.numpy() == np.asarray(wp))) >= 0.99


# ------------------------------------------------------ w8_matmul / _wmm

def _w8_case(seed, k, n, container):
    """JAX's layout of a quantized [K, N] weight: int8 bits with
    ``_scale`` (e4m3) or linear int8 with ``_iscale``."""
    w = _rows(seed, (k, n), k ** -0.5)
    amax = np.abs(w).max(axis=0, keepdims=True)
    if container == "e4m3":
        s = np.maximum(amax, 1e-30) / np.float32(448.0)
        q = np.array(jax.lax.bitcast_convert_type(
            jnp.asarray(w / s).astype(jnp.float8_e4m3fn), jnp.int8))
        q[0, :4] = [1, -127, 0x7F, 5]  # denormals and the NaN code
        return q, s.astype(np.float32), "_scale"
    s = np.maximum(amax, 1e-30) / np.float32(127.0)
    q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32), "_iscale"


@pytest.mark.parametrize("container", ["e4m3", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 37])
def test_w8_matmul_equals_jax_wmm(container, dtype, rows):
    """The CPU route of ``w8_matmul`` (its plain version) against JAX's
    ``_wmm`` on JAX's containers, e4m3 denormal codes and the NaN code in
    the weight."""
    k, n = 96, 80
    q, s, suf = _w8_case(rows, k, n, container)
    x = jnp.asarray(_rows(rows + 1, (rows, k)), dtype)
    want = jax_engine._wmm(x, {"w": jnp.asarray(q), "w" + suf:
                               jnp.asarray(s)}, "w")
    w = torch.from_numpy(q)
    if container == "e4m3":
        w = w.view(torch.float8_e4m3fn)
    got = w8_matmul(_t(x), w, torch.from_numpy(s))
    assert got.dtype == _t(x).dtype and got.shape == (rows, n)
    _close(got, want, 1e-5 if dtype == "float32" else 2 ** -7)
    torch.testing.assert_close(got, w8_matmul_plain(_t(x), w,
                                                    torch.from_numpy(s)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("container", ["e4m3", "int8"])
@pytest.mark.parametrize("rows,tm", [(8, 16), (20, 32), (37, 128)])
def test_w8_route_through_the_grouped_gemm(container, rows, tm):
    """What a CUDA tensor runs, on the CPU: the grouped GEMM as one group
    with no tile map, ``rows`` rows under the tm-row tiles, per-column
    scales and the bit decode, against the f32 product of the decoded
    weight (the plain version of ``w8_matmul`` in f32 rows)."""
    k, n = 64, 48
    q, s, _ = _w8_case(3, k, n, container)
    w = torch.from_numpy(q)
    if container == "e4m3":
        w = w.view(torch.float8_e4m3fn)
    x = torch.from_numpy(_rows(4, (rows, k)))
    sc = torch.from_numpy(s)
    got = grouped_gemm_padded(x, w[None], None, sc.reshape(1, n),
                              out_dtype=torch.float32, e4m3_ftz=True, tm=tm)
    assert got.shape == (rows, n)
    torch.testing.assert_close(got, w8_matmul_plain(x, w, sc), rtol=1e-5,
                               atol=1e-5)
