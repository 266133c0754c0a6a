"""The port's elementwise ops and sampler against the JAX package on the
same numpy inputs.

RMSNorm, RoPE and SiLU compute in f32 in both packages: f32 inputs agree to
atol 1e-5 (reductions and transcendentals in other orders), bf16 outputs to
one bf16 rounding step (rtol 2**-7); the fused norm's new residual (one
f32 add, one rounding) agrees bit for bit, and the serving steps give the
same bits with the fused norm as with the add and the norm apart. The sampler's plain version draws the
same tokens as the TPU kernel ``_family_call(interpret=True)`` for the same
int32 seed; its renormalised rows agree to atol 1e-6."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from flashinfer_tpu.ops import activation as jax_act
from flashinfer_tpu.ops import norm as jax_norm
from flashinfer_tpu.ops import rope as jax_rope
from flashinfer_tpu.ops import sampling as jax_sampling
from flashinfer_tpu_torch.models import deepseek as torch_ds
from flashinfer_tpu_torch.models.llama import LlamaConfig, llama_init_weights
from flashinfer_tpu_torch.ops import norm as torch_norm
from flashinfer_tpu_torch.ops.activation import silu_and_mul
from flashinfer_tpu_torch.ops.norm import rmsnorm, rmsnorm_plain
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.ops import sampling as torch_sampling
from flashinfer_tpu_torch.ops.sampling import (
    family_call,
    gumbel_noise,
    pivot_search_plain,
    sampler_stats,
    softmax,
    top_k_top_p_sampling_from_probs,
)
from flashinfer_tpu_torch.serving import engine as torch_engine

DTYPES = {"f32": (np.float32, torch.float32, 1e-5, 1e-5),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, 1e-5, 2**-7)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("weight_bias", [0.0, 1.0])
def test_rmsnorm_matches_jax(dt, weight_bias):
    np_dt, _, atol, rtol = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 96)).astype(np_dt)
    w = rng.standard_normal(96).astype(np_dt)
    want = jax_norm.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                            weight_bias=weight_bias)
    kernel = jax_norm.rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                     weight_bias=weight_bias, interpret=True)
    got = rmsnorm(_to_torch(x), _to_torch(w), 1e-5, weight_bias=weight_bias)
    assert got.dtype == _to_torch(x).dtype
    _close(got, want, atol, rtol)
    _close(got, kernel, atol, rtol)
    _close(rmsnorm_plain(_to_torch(x), _to_torch(w), 1e-5,
                         weight_bias=weight_bias), want, atol, rtol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["fused_add_rmsnorm",
                                  "gemma_fused_add_rmsnorm"])
def test_fused_add_rmsnorm_matches_jax(dt, form):
    np_dt, _, atol, rtol = DTYPES[dt]
    rng = np.random.default_rng(2)
    x, res = (rng.standard_normal((5, 96)).astype(np_dt) for _ in range(2))
    w = rng.standard_normal(96).astype(np_dt)
    want, want_res = getattr(jax_norm, form)(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(w), 1e-5)
    got, got_res = getattr(torch_norm, form)(
        _to_torch(x), _to_torch(res), _to_torch(w), 1e-5)
    assert got.dtype == got_res.dtype == _to_torch(x).dtype
    assert torch.equal(got_res, _to_torch(np.asarray(want_res)))
    _close(got, want, atol, rtol)
    # the norm is taken of the rounded new residual
    bias = 1.0 if form.startswith("gemma") else 0.0
    assert torch.equal(got, rmsnorm_plain(got_res, _to_torch(w), 1e-5,
                                          weight_bias=bias))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemma_rmsnorm_matches_jax(dt):
    np_dt, _, atol, rtol = DTYPES[dt]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1000)).astype(np_dt)
    w = rng.standard_normal(1000).astype(np_dt)
    want = jax_norm.gemma_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(torch_norm.gemma_rmsnorm(_to_torch(x), _to_torch(w), 1e-6), want,
           atol, rtol)


def _two_op(x, residual, weight, eps=1e-6, *, weight_bias=0.0):
    """The add and the norm apart, as the serving steps ran them before
    the fused norm: ``residual = residual + x``, then ``rmsnorm``."""
    new = residual + x
    return rmsnorm(new, weight, eps, weight_bias=weight_bias), new


def _unfused(monkeypatch, module):
    """Make ``module``'s norms run the add and the norm apart."""
    monkeypatch.setattr(torch_norm, "fused_add_rmsnorm", _two_op)
    monkeypatch.setattr(module, "fused_add_rmsnorm", _two_op)


def _random_norms(params, gen):
    for k, v in params.items():
        if k.endswith("_norm"):
            params[k] = (1 + 0.2 * torch.randn(v.shape, generator=gen)).to(
                v.dtype)


def test_llama_engine_fused_norms_give_the_two_op_bits(monkeypatch):
    """bf16 tiny Llama (2 layers) on the CPU: every step's logits (prefill,
    whose final norm selects rows first, and decode) are the same bits with
    the fused norms as with the add and the norm apart."""
    mc = LlamaConfig.tiny(torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = llama_init_weights(gen, mc, "cpu")
    _random_norms(params, gen)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist() for n in (9, 4, 21)]

    def serve():
        cfg = torch_engine.EngineConfig(
            model=mc, device="cpu", max_batch=4, num_pages=64, page_size=8,
            max_seq_len=128, greedy=True)
        eng = torch_engine.LlamaServingEngine(cfg, params=dict(params))
        seen, sample = [], eng._sample_tokens

        def record(logits, seed):
            seen.append(logits.clone())
            return sample(logits, seed)

        eng._sample_tokens = record
        reqs = [eng.add_request(p, 4) for p in prompts]
        eng.run_to_completion(max_steps=50)
        return seen, [r.output for r in reqs]

    fused, fused_out = serve()
    _unfused(monkeypatch, torch_engine)
    apart, apart_out = serve()
    assert fused_out == apart_out
    assert len(fused) == len(apart) > 1
    assert all(torch.equal(a, b) for a, b in zip(fused, apart))


def test_deepseek_step_fused_norms_give_the_two_op_bits(monkeypatch):
    """bf16 tiny DeepSeek (2 layers) on the CPU through the serving loop:
    the residual stream entering every norm of every step, the logits and
    the caches are the same bits with the fused norms as apart."""
    cfg = torch_ds.DeepSeekConfig.tiny(torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    params = torch_ds.deepseek_init_weights(gen, cfg, "cpu")
    _random_norms(params, gen)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                (2, 3)).tolist()

    def serve():
        with chip_smoke._step_recorder(torch) as rec:
            run = chip_smoke.deepseek_serve(torch, np, cfg, params, prompts,
                                            2, device="cpu", sampled=False)
        return run, rec["x"]

    fused, fused_x = serve()
    _unfused(monkeypatch, torch_ds)
    apart, apart_x = serve()
    assert fused["outs"] == apart["outs"]
    assert len(fused_x) == len(apart_x) == 4 * (2 * cfg.num_layers + 1)
    assert all(torch.equal(a, b) for a, b in zip(fused_x, apart_x))
    for key in ("logits0", "logits", "ckv", "kpe"):
        assert torch.equal(fused[key], apart[key]), key


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_matches_jax(dt):
    np_dt, _, atol, rtol = DTYPES[dt]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, 4, 32)).astype(np_dt)
    k = rng.standard_normal((6, 2, 32)).astype(np_dt)
    pos = rng.integers(0, 4000, 6).astype(np.int32)
    wq, wk = jax_rope.apply_rope_pos_ids(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(pos), rope_theta=5e5)
    gq, gk = apply_rope_pos_ids(_to_torch(q), _to_torch(k),
                                torch.from_numpy(pos).long(), rope_theta=5e5)
    # angles reach ~4000 rad: sin/cos of a large f32 argument differ by
    # a few ulps of the angle between libraries
    _close(gq, wq, 1e-4, rtol)
    _close(gk, wk, 1e-4, rtol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_silu_and_mul_matches_jax(dt):
    np_dt, _, atol, rtol = DTYPES[dt]
    x = np.random.default_rng(2).standard_normal((7, 64)).astype(np_dt)
    _close(silu_and_mul(_to_torch(x)),
           jax_act.silu_and_mul(jnp.asarray(x)), atol, rtol)


@pytest.mark.parametrize("temperature", [1.0, 0.7, [0.5, 0.0, 2.0]])
def test_softmax_matches_jax(temperature):
    x = np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32)
    x[1, 7] = x[1, 9] = 5.0  # a tie under temperature 0
    want = jax_sampling.softmax(jnp.asarray(x), jnp.asarray(temperature))
    got = softmax(torch.from_numpy(x), torch.tensor(temperature))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _probs(rng, batch, vocab):
    logits = rng.standard_normal((batch, vocab)).astype(np.float32) * 3.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _jax_seed(key):
    return int(jax.random.randint(key, (1,), 0, 2**31 - 1, jnp.int32)[0])


@pytest.mark.parametrize("filt", ["none", "top_k", "top_p", "min_p",
                                  "top_k_top_p_joint", "top_k_top_p_seq"])
def test_sampler_family_tokens_match_jax(filt):
    rng = np.random.default_rng(4)
    batch, vocab = 11, 300  # two row blocks of the TPU kernel, padded lanes
    probs = _probs(rng, batch, vocab)
    k = rng.integers(1, 40, (batch, 1)).astype(np.int32)
    k[0] = vocab  # keeps everything
    p = rng.uniform(0.3, 0.95, (batch, 1)).astype(np.float32)
    p[1] = 1.0
    if filt == "min_p":
        p = p * 0.2
    for i in range(3):
        key = jax.random.key(100 + i)
        want = jax_sampling._family_call(
            jnp.asarray(probs), key, jnp.asarray(k), jnp.asarray(p),
            filt=filt, out_mode="sample", interpret=True)
        got = family_call(torch.from_numpy(probs), _jax_seed(key),
                          torch.from_numpy(k), torch.from_numpy(p),
                          filt=filt, out_mode="sample")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("filt", ["top_k", "top_p", "top_k_top_p_seq"])
def test_sampler_family_renorm_matches_jax(filt):
    rng = np.random.default_rng(5)
    probs = _probs(rng, 4, 200)
    k = np.full((4, 1), 17, np.int32)
    p = np.full((4, 1), 0.8, np.float32)
    want = jax_sampling._family_call(
        jnp.asarray(probs), None, jnp.asarray(k), jnp.asarray(p), filt=filt,
        out_mode="renorm", interpret=True)
    got = family_call(torch.from_numpy(probs), 0, torch.from_numpy(k),
                      torch.from_numpy(p), filt=filt, out_mode="renorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sampler_family_mask_logits_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 200)).astype(np.float32)
    k = np.asarray([[1], [10], [199], [200]], np.int32)
    want = jax_sampling._family_call(
        jnp.asarray(logits), None, jnp.asarray(k), jnp.ones((4, 1)),
        filt="top_k", out_mode="mask_logits", interpret=True)
    got = family_call(torch.from_numpy(logits), 0, torch.from_numpy(k), 1.0,
                      filt="top_k", out_mode="mask_logits")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("order,filt", [("top_k_first", "top_k_top_p_seq"),
                                        ("joint", "top_k_top_p_joint")])
def test_top_k_top_p_sampling_matches_jax(order, filt):
    rng = np.random.default_rng(7)
    probs = _probs(rng, 8, 500)
    key = jax.random.key(9)
    want = jax_sampling._family_call(
        jnp.asarray(probs), key, jnp.full((8, 1), 40, jnp.int32),
        jnp.full((8, 1), 0.9, jnp.float32), filt=filt, out_mode="sample",
        interpret=True)
    got = top_k_top_p_sampling_from_probs(
        torch.from_numpy(probs), 40, 0.9, seed=_jax_seed(key),
        filter_apply_order=order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_noise_is_the_murmur3_hash():
    """Spot values of the hash, computed with Python integers."""
    def mix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    seed = 2**31 - 2
    g = gumbel_noise(seed, 3, 70000)
    for row, lane in ((0, 0), (2, 69999), (1, 12345)):
        h = (seed + row * 0x9E3779B9 + lane * 40503) & 0xFFFFFFFF
        u = np.float32(mix(mix(h)) >> 8) * np.float32(1.0 / (1 << 24)) \
            + np.float32(1e-7)
        want = -np.log(-np.log(np.float32(u)))
        assert abs(float(g[row, lane]) - float(want)) < 1e-5


def _pivot_rows():
    """Rows a pivot search must get right, [6, 300] f32 with k and p: a
    peaked row, one with ties, one with k >= V and p >= 1, one with
    denormal entries, and a one-hot row."""
    rng = np.random.default_rng(11)
    x = _probs(rng, 6, 300)
    x[1] = np.repeat(rng.dirichlet(np.ones(30)), 10) / 10  # tied pairs
    x[3, :200] = np.float32(1e-40)  # denormals
    x[3, 200:] /= x[3, 200:].sum()
    x[4] = 0.0
    x[4, 123] = 1.0
    k = np.asarray([[40], [7], [300], [25], [40], [299]], np.int32)
    p = np.asarray([[0.9], [0.5], [1.0], [0.8], [0.9], [0.99]], np.float32)
    return torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(p)


@pytest.mark.parametrize("mode", ["count", "mass"])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_pivot_search_takes_the_bisections_steps(levels, mode):
    """Steps taken ``levels`` a sweep, as the cluster kernel takes them,
    give the 32-step loop's pivots bit for bit: on the rows, on the rows
    padded to 384 lanes as a kernel pads them (0, or -inf for logits), and
    on logits between the row min and max. Counts are exact, so a padded
    row's count pivots are the row's."""
    x, k, p = _pivot_rows()
    if mode == "count":
        def ok(v, mid):
            return (v > mid).sum(dim=-1, keepdim=True) >= k
    else:
        def ok(v, mid):
            return torch.where(v > mid, v, 0.0).sum(dim=-1,
                                                   keepdim=True) >= p

    def both(v, lo, hi):
        want = torch_sampling._bisect(v, ok, lo, hi)
        got = pivot_search_plain(v, ok, lo, hi, levels)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        return got

    lo, hi = torch.zeros(6, 1), x.amax(dim=-1, keepdim=True)
    row = both(x, lo, hi)
    padded = both(torch.cat([x, torch.zeros(6, 84)], -1), lo, hi)
    logits = torch.log(x + 1e-30)
    lo, hi = logits.amin(-1, keepdim=True), logits.amax(-1, keepdim=True)
    both(torch.cat([logits, torch.full((6, 84), float("-inf"))], -1), lo, hi)
    if mode == "count":
        assert torch.equal(padded, row)


def _int32_hash_noise(seed, batch, vocab):
    """The TPU kernel's noise as ``_family_kernel`` writes it
    (flashinfer_tpu/ops/sampling.py:577-590): int32 arithmetic with
    wrap-around, logical shifts, in numpy."""
    with np.errstate(over="ignore"):
        row = np.arange(batch, dtype=np.int32)[:, None]
        lane = np.arange(vocab, dtype=np.int32)[None, :]
        x = (np.int32(seed) + row * np.int32(-1640531527)
             + lane * np.int32(40503))

        def srl(h, n):
            return (h.view(np.uint32) >> np.uint32(n)).view(np.int32)

        def mix(h):
            h = h ^ srl(h, 16)
            h = h * np.int32(-2048144789)
            h = h ^ srl(h, 13)
            h = h * np.int32(-1028477387)
            return h ^ srl(h, 16)

        u24 = srl(mix(mix(x)), 8)
    u = u24.astype(np.float32) * np.float32(1.0 / (1 << 24)) \
        + np.float32(1e-7)
    return -np.log(-np.log(u))


@pytest.mark.parametrize("seed", [-1, 0, 2**31 - 1])
def test_gumbel_noise_is_the_int32_hash_of_the_seed(seed):
    """The plain version's noise takes the seed's 32 bits as the TPU
    kernel's int32 arithmetic does, negative seeds included."""
    got = gumbel_noise(seed, 3, 5000).numpy()
    want = _int32_hash_noise(seed, 3, 5000)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_family_call_takes_the_seeds_low_32_bits():
    probs = torch.from_numpy(_probs(np.random.default_rng(12), 4, 700))
    kw = dict(filt="top_k_top_p_seq", out_mode="sample")
    a = family_call(probs, -1, 40, 0.9, **kw)
    assert torch.equal(a, family_call(probs, 2**32 - 1, 40, 0.9, **kw))
    assert torch.equal(a, family_call(probs, torch.tensor([-1],
                                                          dtype=torch.int32),
                                      40, 0.9, **kw))
    for bad in (2**32, -2**31 - 1):
        with pytest.raises(ValueError):
            family_call(probs, bad, 40, 0.9, **kw)


def test_sampler_on_cpu_rows_counts_no_launch():
    """CPU rows take the plain version: no kernel launch is counted, and
    only a launch on CUDA rows reports its passes."""
    probs = torch.from_numpy(_probs(np.random.default_rng(13), 2, 300))
    before = family_call.launches
    family_call(probs, 3, 40, 0.9, filt="top_k_top_p_seq", out_mode="sample")
    assert family_call.launches == before
    with pytest.raises(ValueError):
        sampler_stats(probs, 40, 0.9, filt="top_k_top_p_seq",
                      out_mode="sample")


def test_sampling_needs_a_seed_or_generator():
    probs = torch.full((2, 10), 0.1)
    with pytest.raises(ValueError):
        top_k_top_p_sampling_from_probs(probs, 3, 0.9)
    gen = torch.Generator().manual_seed(0)
    a = top_k_top_p_sampling_from_probs(probs, 3, 0.9, generator=gen)
    assert a.shape == (2,) and bool((a < 10).all())


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("rotary_dim", [None, 16])
def test_rope_interleave_matches_jax(interleave, rotary_dim):
    """Both pairings, whole and partial rotary dims; positions below 64 keep
    the angles small, so sin and cos agree to f32 roundoff."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal((6, 4, 32)).astype(np.float32)
    k = rng.standard_normal((6, 2, 32)).astype(np.float32)
    pos = rng.integers(0, 64, 6).astype(np.int32)
    kw = dict(rotary_dim=rotary_dim, interleave=interleave, rope_theta=1e4)
    wq, wk = jax_rope.apply_rope_pos_ids(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(pos), **kw)
    gq, gk = apply_rope_pos_ids(_to_torch(q), _to_torch(k),
                                torch.from_numpy(pos).long(), **kw)
    _close(gq, wq, 1e-6, 0)
    _close(gk, wk, 1e-6, 0)


@pytest.mark.parametrize("name", ["silu_and_mul", "gelu_and_mul"])
def test_gated_activations_take_enable_pdl(name):
    """``enable_pdl`` is a launch hint: accepted, and the output is JAX's
    whatever its value."""
    from flashinfer_tpu_torch.ops import activation as torch_act

    x = np.random.default_rng(15).standard_normal((5, 64)).astype(np.float32)
    want = getattr(jax_act, name)(jnp.asarray(x), enable_pdl=True)
    for pdl in (None, True, False):
        _close(getattr(torch_act, name)(_to_torch(x), enable_pdl=pdl), want,
               1e-5, 1e-5)


# the port's sampler function, JAX's _family_call filter, and the k and p it
# passes (None: JAX's Pallas branch passes ones)
SURFACE = {
    "sampling_from_probs": ("none", None, None),
    "top_p_sampling_from_probs": ("top_p", None, "p"),
    "top_k_sampling_from_probs": ("top_k", "k", None),
    "min_p_sampling_from_probs": ("min_p", None, "min_p"),
    "top_k_top_p_sampling_from_probs": ("top_k_top_p_seq", "k", "p"),
}


@pytest.mark.parametrize("name", list(SURFACE))
def test_sampler_surface_tokens_match_jax(name):
    """Each sampler, rows chosen by ``indices`` (repeats included), draws
    the TPU kernel's tokens (``_family_call(interpret=True)``) for the same
    int32 seed, with per-row and scalar parameters."""
    rng = np.random.default_rng(16)
    probs = _probs(rng, 5, 300)
    idx = np.asarray([0, 2, 2, 4, 1, 0, 3, 3])
    rows = len(idx)
    args = dict(k=rng.integers(1, 40, (rows, 1)).astype(np.int32),
                p=rng.uniform(0.3, 0.95, (rows, 1)).astype(np.float32),
                min_p=np.full((rows, 1), 0.1, np.float32))
    filt, k_arg, p_arg = SURFACE[name]
    k = args[k_arg] if k_arg else np.ones((rows, 1), np.int32)
    p = args[p_arg] if p_arg else np.ones((rows, 1), np.float32)
    key = jax.random.key(17)
    want = jax_sampling._family_call(
        jnp.asarray(probs[idx]), key, jnp.asarray(k), jnp.asarray(p),
        filt=filt, out_mode="sample", interpret=True)
    fn = getattr(torch_sampling, name)
    params = [torch.from_numpy(args[a][:, 0]) for a in (k_arg, p_arg) if a]
    got = fn(torch.from_numpy(probs), *params, indices=torch.from_numpy(idx),
             seed=_jax_seed(key), deterministic=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "top_k_top_p_sampling_from_probs":
        scalar = fn(torch.from_numpy(probs[idx]), 40, 0.9, seed=5,
                    backend="auto")
        assert torch.equal(scalar, family_call(
            torch.from_numpy(probs[idx]), 5, 40, 0.9,
            filt="top_k_top_p_seq", out_mode="sample"))


def test_sampling_from_logits_matches_jax():
    """Rows at temperature > 0 draw the kernel's token on JAX's temperature
    softmax; rows at temperature 0 take JAX's argmax."""
    rng = np.random.default_rng(18)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    logits[1, 10] = logits[1, 20] = 50.0  # an argmax tie: the first wins
    t = np.asarray([0.7, 0.0, 1.3, 1.0, 0.0, 0.4], np.float32)
    key = jax.random.key(19)
    got = torch_sampling.sampling_from_logits(
        torch.from_numpy(logits), temperature=torch.from_numpy(t),
        seed=_jax_seed(key)).numpy()
    drawn = np.asarray(jax_sampling._family_call(
        jax_sampling.softmax(jnp.asarray(logits), jnp.asarray(t)), key,
        jnp.ones((6, 1), jnp.int32), jnp.ones((6, 1), jnp.float32),
        filt="none", out_mode="sample", interpret=True))
    argmax = np.asarray(jax_sampling.sampling_from_logits(
        jnp.asarray(logits), key, temperature=jnp.asarray(t)))
    np.testing.assert_array_equal(got, np.where(t > 0, drawn, argmax))
    assert got[1] == 10
    idx = torch.tensor([4, 1])
    np.testing.assert_array_equal(torch_sampling.sampling_from_logits(
        torch.from_numpy(logits), indices=idx, temperature=0.0, seed=0),
        argmax[[4, 1]])


@pytest.mark.parametrize("order,filt", [("top_k_first", "top_k_top_p_seq"),
                                        ("joint", "top_k_top_p_joint")])
def test_top_k_top_p_sampling_from_logits_matches_jax(order, filt):
    rng = np.random.default_rng(20)
    logits = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    key = jax.random.key(21)
    want = jax_sampling._family_call(
        jax.nn.softmax(jnp.asarray(logits), axis=-1), key,
        jnp.full((4, 1), 30, jnp.int32), jnp.full((4, 1), 0.8, jnp.float32),
        filt=filt, out_mode="sample", interpret=True)
    got = torch_sampling.top_k_top_p_sampling_from_logits(
        torch.from_numpy(logits), 30, 0.8, seed=_jax_seed(key),
        filter_apply_order=order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["top_p_renorm_probs", "top_k_renorm_probs",
                                  "top_k_mask_logits"])
def test_renorm_and_mask_surface_match_jax(name):
    """The renormalised rows agree with JAX's function and the TPU kernel
    to 1e-6, the masked logits exactly; per-row and scalar parameters."""
    rng = np.random.default_rng(22)
    mask = name == "top_k_mask_logits"
    x = (rng.standard_normal((4, 200)).astype(np.float32) if mask
         else _probs(rng, 4, 200))
    param = (np.asarray([1, 10, 199, 200], np.int32) if "top_k" in name
             else np.asarray([0.5, 0.8, 0.95, 1.0], np.float32))
    jax_fn, fn = getattr(jax_sampling, name), getattr(torch_sampling, name)
    filt = "top_p" if "top_p" in name else "top_k"
    k = param[:, None] if filt == "top_k" else np.ones((4, 1), np.int32)
    p = param[:, None] if filt == "top_p" else np.ones((4, 1), np.float32)
    kernel = jax_sampling._family_call(
        jnp.asarray(x), None, jnp.asarray(k), jnp.asarray(p), filt=filt,
        out_mode="mask_logits" if mask else "renorm", interpret=True)
    for arg in (param, param[2]):
        want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(arg)))
        got = fn(torch.from_numpy(x), torch.as_tensor(arg),
                 backend="auto").numpy()
        if mask:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)
    got = fn(torch.from_numpy(x), torch.from_numpy(param)).numpy()
    if mask:
        np.testing.assert_array_equal(got, np.asarray(kernel))
    else:
        np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-6)


def test_sampler_surface_takes_the_jax_keywords():
    """Every keyword of JAX's sampler functions but the PRNG key is the
    port's (the key's place is taken by ``seed`` / ``generator``)."""
    import inspect

    for name in jax_sampling.__all__:
        ours = inspect.signature(getattr(torch_sampling, name)).parameters
        theirs = inspect.signature(getattr(jax_sampling, name)).parameters
        missing = set(theirs) - set(ours) - {"key"}
        assert not missing, (name, missing)
        if "key" in theirs:
            assert {"seed", "generator"} <= set(ours), name
