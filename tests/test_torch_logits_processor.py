"""The logits-processor pipe: the port against the JAX package on the same
numpy logits.

Compiled step names must equal JAX's for every processor list. Sampled
tokens: a fused step draws the TPU kernel's tokens
(``_family_call(interpret=True)``) for the same int32 seed, exactly (JAX's
own pipe samples on the CPU by XLA's inverse-CDF path, so its sampled
tokens are compared by membership, as JAX's tests do); greedy pipes give
JAX's tokens exactly. Renormalised probabilities agree to 1e-6 (f32
reductions in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu import logits_processor as jlp
from flashinfer_tpu.ops import sampling as jax_sampling
from flashinfer_tpu_torch import logits_processor as lp

# processor lists, by the names both packages give their classes
PIPES = {
    "temp_softmax_topk_topp_sample": (["Temperature", "Softmax", "TopK",
                                       "TopP", "Sample"], "logits"),
    "softmax_sample": (["Softmax", "Sample"], "logits"),
    "softmax_topp_sample": (["Softmax", "TopP", "Sample"], "logits"),
    "softmax_topk_sample": (["Softmax", "TopK", "Sample"], "logits"),
    "topk_softmax_sample": (["TopK", "Softmax", "Sample"], "logits"),
    "temp_softmax_minp_sample": (["Temperature", "Softmax", "MinP",
                                  "Sample"], "logits"),
    "topk_softmax_topp_sample": (["TopK", "Softmax", "TopP", "Sample"],
                                 "logits"),
    "sample_logits": (["Sample"], "logits"),
    "softmax_topk_topp": (["Softmax", "TopK", "TopP"], "logits"),
    "minp_sample": (["MinP", "Sample"], "probs"),
    "topk_sample_probs": (["TopK", "Sample"], "probs"),
    "topk_topp_sample_probs": (["TopK", "TopP", "Sample"], "probs"),
    "sample_probs": (["Sample"], "probs"),
    "minp_topk_sample": (["MinP", "TopK", "Sample"], "probs"),
}


def _logits(rng, b=4, v=32):
    return (rng.standard_normal((b, v)) * 3).astype(np.float32)


def _jax_seed(key):
    return int(jax.random.randint(key, (1,), 0, 2**31 - 1, jnp.int32)[0])


def _pipes(names, kind):
    typ = {"logits": "LOGITS", "probs": "PROBS"}[kind]
    want = jlp.LogitsPipe([getattr(jlp, n)() for n in names],
                          input_type=getattr(jlp.TensorType, typ))
    got = lp.LogitsPipe([getattr(lp, n)() for n in names],
                        input_type=getattr(lp.TensorType, typ))
    return got, want


@pytest.mark.parametrize("case", list(PIPES))
def test_compiled_names_equal_jax(case):
    got, want = _pipes(*PIPES[case])
    assert got.compiled_names == want.compiled_names


def test_pipe_fusion_names():
    pipe = lp.LogitsPipe([lp.Temperature(), lp.Softmax(), lp.TopK(),
                          lp.TopP(), lp.Sample()])
    assert pipe.compiled_names == ["temperature", "softmax",
                                   "fused_topk_topp_sample"]
    assert lp.LogitsPipe([lp.Softmax(), lp.Sample()]).compiled_names == [
        "fused_softmax_sample"]
    assert lp.LogitsPipe([lp.Softmax(), lp.TopP(), lp.Sample()]
                         ).compiled_names == ["softmax", "fused_topp_sample"]


def test_pipe_topk_topp_sample_membership():
    rng = np.random.default_rng(0)
    logits = _logits(rng)
    pipe = lp.LogitsPipe([lp.Temperature(), lp.Softmax(), lp.TopK(),
                          lp.TopP(), lp.Sample()])
    ids = pipe(torch.from_numpy(logits), temperature=1.0, top_k=5,
               top_p=0.9, seed=0)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    for t in range(logits.shape[0]):
        assert int(ids[t]) in set(np.argsort(-probs[t])[:5].tolist())


def test_pipe_greedy_with_topk1():
    rng = np.random.default_rng(1)
    logits = _logits(rng)
    pipe = lp.LogitsPipe([lp.Softmax(), lp.TopK(), lp.Sample()])
    ids = pipe(torch.from_numpy(logits), top_k=1, seed=1)
    np.testing.assert_array_equal(ids.numpy(), np.argmax(logits, -1))


def test_pipe_topk_mask_on_logits():
    pipe = lp.LogitsPipe([lp.TopK(), lp.Softmax(), lp.Sample()])
    assert pipe.compiled_names == ["topk_mask_logits", "fused_softmax_sample"]
    rng = np.random.default_rng(2)
    logits = _logits(rng)
    ids = pipe(torch.from_numpy(logits), top_k=3, seed=2)
    for t in range(logits.shape[0]):
        assert int(ids[t]) in set(np.argsort(-logits[t])[:3].tolist())


def test_pipe_probs_input():
    rng = np.random.default_rng(3)
    p = np.abs(rng.standard_normal((2, 8))).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    pipe = lp.LogitsPipe([lp.MinP(), lp.Sample()],
                         input_type=lp.TensorType.PROBS)
    assert pipe.compiled_names == ["fused_minp_sample"]
    ids = pipe(lp.TaggedTensor.probs(torch.from_numpy(p)), min_p=0.2, seed=3)
    for t in range(2):
        assert p[t][int(ids[t])] >= 0.2 * p[t].max() - 1e-6
    with pytest.raises(TypeError):  # a pipe of probabilities fed logits
        pipe(lp.TaggedTensor.logits(torch.from_numpy(p)), min_p=0.2, seed=3)


def test_pipe_type_validation():
    # TopP needs probabilities; JAX asserts, the port raises TypeError
    with pytest.raises(AssertionError):
        jlp.LogitsPipe([jlp.TopP(), jlp.Sample()])
    with pytest.raises(TypeError):
        lp.LogitsPipe([lp.TopP(), lp.Sample()])


def test_pipe_constructor_params():
    rng = np.random.default_rng(4)
    logits = _logits(rng)
    pipe = lp.LogitsPipe([lp.Softmax(), lp.TopK(top_k=2),
                          lp.Sample(seed=4)])
    ids = pipe(torch.from_numpy(logits))
    for t in range(logits.shape[0]):
        assert int(ids[t]) in set(np.argsort(-logits[t])[:2].tolist())
    with pytest.raises(ValueError):  # no seed and no generator
        lp.LogitsPipe([lp.Softmax(), lp.Sample()])(torch.from_numpy(logits))
    gen = torch.Generator().manual_seed(9)
    assert lp.LogitsPipe([lp.Softmax(), lp.Sample()])(
        torch.from_numpy(logits), generator=gen).shape == (4,)


# greedy pipes: every filter leaves one token a row
GREEDY = {
    "topk1": (["Softmax", "TopK", "Sample"], dict(top_k=1)),
    "topk1_logits": (["TopK", "Softmax", "Sample"], dict(top_k=1)),
    "topk1_topp": (["Temperature", "Softmax", "TopK", "TopP", "Sample"],
                   dict(temperature=0.7, top_k=1, top_p=0.9)),
    "minp1": (["Softmax", "MinP", "Sample"], dict(min_p=1.0)),
    "topp_tiny": (["Softmax", "TopP", "Sample"], dict(top_p=1e-4)),
    "topk1_masked_topp": (["TopK", "Softmax", "TopP", "Sample"],
                          dict(top_k=1, top_p=0.5)),
}


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_pipes_equal_jax(case):
    names, params = GREEDY[case]
    rng = np.random.default_rng(5)
    logits = _logits(rng, b=6, v=64)
    got, want = _pipes(names, "logits")
    key = jax.random.key(5)
    ids_j = np.asarray(want(jnp.asarray(logits), key=key, **params))
    ids_t = got(torch.from_numpy(logits), seed=_jax_seed(key), **params)
    assert ids_t.dtype == torch.int32
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    np.testing.assert_array_equal(ids_j, np.argmax(logits, -1))


# fused steps: the sampler family's filter and the parameters it takes
FUSED = {
    "fused_softmax_sample": (["Softmax", "Sample"], "none", {}),
    "fused_topk_topp_sample": (["Softmax", "TopK", "TopP", "Sample"],
                               "top_k_top_p_seq", dict(top_k=7, top_p=0.8)),
    "fused_topk_sample": (["Softmax", "TopK", "Sample"], "top_k",
                          dict(top_k=7)),
    "fused_topp_sample": (["Softmax", "TopP", "Sample"], "top_p",
                          dict(top_p=0.8)),
    "fused_minp_sample": (["Softmax", "MinP", "Sample"], "min_p",
                          dict(min_p=0.1)),
}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_steps_draw_the_tpu_kernels_tokens(name):
    """Each fusion draws ``_family_call(interpret=True)``'s tokens on JAX's
    softmax for the same int32 seed."""
    names, filt, params = FUSED[name]
    rng = np.random.default_rng(6)
    b, v = 5, 300
    logits = _logits(rng, b, v)
    pipe = lp.LogitsPipe([getattr(lp, n)() for n in names])
    assert pipe.compiled_names[-1] == name
    key = jax.random.key(7)
    k = np.full((b, 1), params.get("top_k", 1), np.int32)
    p = np.full((b, 1), params.get("top_p", params.get("min_p", 1.0)),
                np.float32)
    want = jax_sampling._family_call(
        jax.nn.softmax(jnp.asarray(logits), -1), key, jnp.asarray(k),
        jnp.asarray(p), filt=filt, out_mode="sample", interpret=True)
    got = pipe(torch.from_numpy(logits), seed=_jax_seed(key), **params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("names,params", [
    (["Softmax", "TopK", "TopP"], dict(top_k=5, top_p=0.7)),
    (["TopK"], dict(top_k=4)),
    (["Temperature", "Softmax", "MinP"], dict(temperature=0.5, min_p=0.05)),
])
def test_unfused_steps_match_jax(names, params):
    """Pipes that end before a draw: JAX's probabilities (to 1e-6) or
    masked logits (exactly)."""
    rng = np.random.default_rng(8)
    logits = _logits(rng, 3, 50)
    got, want = _pipes(names, "logits")
    w = np.asarray(want(jnp.asarray(logits), **params))
    g = got(torch.from_numpy(logits), **params).numpy()
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [0.7, 0.0, "rows"])
def test_temperature_promotes_bf16_logits_as_jax(temperature):
    """``Temperature`` on bf16 logits returns JAX's f32 quotient: the dtype
    and, since both divide the same f32 values by the same f32
    temperature, the values exactly. A row at temperature <= 0 stays as it
    is (divided by 1)."""
    rng = np.random.default_rng(21)
    logits = (rng.standard_normal((2, 1000)) * 4).astype(np.float32)
    t = (np.array([0.7, -1.0], np.float32) if temperature == "rows"
         else temperature)
    want = jlp.Temperature().apply(jnp.asarray(logits, jnp.bfloat16),
                                   {"temperature": t})
    got = lp.Temperature().apply(torch.from_numpy(logits).bfloat16(),
                                 {"temperature": t})
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_pipe_on_bf16_logits_draws_the_f32_quotient():
    """[Temperature, Softmax, Sample] on bf16 logits draws the tokens of a
    direct ``sampling_from_logits`` call on the f32 quotient, seed for
    seed."""
    from flashinfer_tpu_torch.ops.sampling import sampling_from_logits

    rng = np.random.default_rng(22)
    x = torch.from_numpy(
        (rng.standard_normal((8, 512)) * 3).astype(np.float32)).bfloat16()
    pipe = lp.LogitsPipe([lp.Temperature(), lp.Softmax(), lp.Sample()])
    for seed in range(4):
        got = pipe(x, temperature=0.7, seed=seed)
        want = sampling_from_logits(x.float() / 0.7, seed=seed)
        assert torch.equal(got, want), seed
