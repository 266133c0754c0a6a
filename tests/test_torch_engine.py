"""The port's serving engine against the JAX engine at LlamaConfig.tiny()
in f32, with the JAX weights carried over by ``params_from_numpy``: greedy
tokens are identical for each KV layout and KV container. Continuous
batching, eos and recompute preemption are checked as in
tests/test_serving_engine.py, and the dense forward against JAX's (f32,
atol 1e-4: two layers of matmuls summed in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.models.llama import (
    LlamaConfig,
    llama_forward_dense,
    params_from_numpy,
)
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    LlamaServingEngine,
)

MC_JAX = jax_llama.LlamaConfig.tiny()
MC = LlamaConfig.tiny()
BASE = dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
            greedy=True)


@pytest.fixture(scope="module")
def np_params():
    params = jax_llama.llama_init_weights(jax.random.key(0), MC_JAX)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params, device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC.vocab_size, n).tolist() for n in lens]


def _serve(eng, prompts, n_new, max_steps=100):
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion(max_steps=max_steps)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _dense_greedy(params, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        logits = llama_forward_dense(params, torch.tensor([toks]), MC)
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
def test_greedy_tokens_match_jax_engine(np_params, params, kv_dtype):
    """Three requests of one to four pages, prefilled together and
    decoded as one batch, in both layouts."""
    prompts = _prompts(7, (9, 4, 21))
    n_new = 5
    jcfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                   kv_dtype=kv_dtype, kv_scale=0.3, **BASE)
    jeng = jax_engine.LlamaServingEngine(
        jcfg, params={k: jnp.asarray(v) for k, v in np_params.items()})
    want = _serve(jeng, prompts, n_new)
    for layout in ("NHD", "HND"):
        cfg = EngineConfig(model=MC, device="cpu", kv_dtype=kv_dtype,
                           kv_scale=0.3, kv_layout=layout, **BASE)
        eng = LlamaServingEngine(cfg, params=params)
        assert _serve(eng, prompts, n_new) == want, (layout, kv_dtype)
        assert eng.pool.free_pages == cfg.num_pages


def test_kv_cache_bits_match_jax_engine(np_params, params):
    """After a prefill the e4m3 cache holds the JAX engine's int8 bits."""
    prompts = _prompts(8, (6, 11))
    jcfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                   kv_dtype="fp8_e4m3", kv_scale=0.3, **BASE)
    jeng = jax_engine.LlamaServingEngine(
        jcfg, params={k: jnp.asarray(v) for k, v in np_params.items()})
    eng = LlamaServingEngine(
        EngineConfig(model=MC, device="cpu", kv_dtype="fp8_e4m3",
                     kv_scale=0.3, **BASE), params=params)
    for e in (jeng, eng):
        for p in prompts:
            e.add_request(p, 1)
        e.step()
    assert eng.k_cache.dtype == torch.float8_e4m3fn
    for ours, ref in ((eng.k_cache, jeng.k_cache), (eng.v_cache, jeng.v_cache)):
        bits = ours.view(torch.int8).numpy()
        ref = np.asarray(ref)
        # the roped K and V go through f32 matmuls in both packages: a
        # value at a rounding boundary may land one e4m3 step apart
        assert np.mean(bits == ref) > 0.999
        assert np.count_nonzero(bits) > 0


def test_dense_forward_matches_jax(np_params, params):
    toks = np.asarray(_prompts(9, (12, 12)), np.int32)
    want = jax_llama.llama_forward_dense(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(toks), MC_JAX)
    got = llama_forward_dense(params, torch.from_numpy(toks).long(), MC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_dense_layer_matches_jax(np_params, params, fused_qkv):
    """One layer (layer 1's weights) on the embedded tokens, wq / wk / wv
    or a fused wqkv, against JAX's ``llama_dense_layer`` (f32, 1e-4)."""
    from flashinfer_tpu_torch.models.llama import PER_LAYER, llama_dense_layer
    from flashinfer_tpu_torch.serving.engine import fuse_qkv_weights

    toks = np.asarray(_prompts(10, (7, 7)), np.int32)
    jlp = {k: jnp.asarray(np_params[k][1]) for k in PER_LAYER
           if k in np_params}
    x = np.asarray(np_params["embedding"])[toks]
    want = jax_llama.llama_dense_layer(jlp, jnp.asarray(x),
                                       jnp.arange(7, dtype=jnp.int32), MC_JAX)
    lp = {k: params[k][1] for k in PER_LAYER if k in params}
    if fused_qkv:
        lp = fuse_qkv_weights(lp)
        assert "wqkv" in lp
    got = llama_dense_layer(lp, torch.from_numpy(x), torch.arange(7), MC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_engine_matches_dense_oracle(params):
    eng = LlamaServingEngine(EngineConfig(model=MC, device="cpu", **BASE),
                             params=params)
    prompts = _prompts(0, (5, 3))
    outs = _serve(eng, prompts, 3)
    for p, got in zip(prompts, outs):
        assert got == _dense_greedy(eng.params, p, 3)


def test_engine_continuous_batching(params):
    """A request arriving mid-flight joins the running decode batch."""
    eng = LlamaServingEngine(EngineConfig(model=MC, device="cpu", **BASE),
                             params=params)
    first_p, late_p = _prompts(1, (6, 4))
    first = eng.add_request(first_p, 4)
    eng.step()
    eng.step()
    late = eng.add_request(late_p, 3)
    eng.run_to_completion(max_steps=50)
    assert first.done and late.done
    assert len(first.output) == 4 and len(late.output) == 3
    assert eng.pool.free_pages == eng.cfg.num_pages
    assert late.output == _dense_greedy(eng.params, late_p, 3)
    assert first.output == _dense_greedy(eng.params, first_p, 4)


def test_engine_queues_beyond_capacity(params):
    eng = LlamaServingEngine(EngineConfig(model=MC, device="cpu", **BASE),
                             params=params)
    outs = _serve(eng, _prompts(2, (4,) * 6), 2)
    assert all(len(o) == 2 for o in outs)
    assert eng.pool.free_pages == eng.cfg.num_pages


def test_engine_eos_stops(params):
    eng = LlamaServingEngine(EngineConfig(model=MC, device="cpu", **BASE),
                             params=params)
    (prompt,) = _prompts(3, (4,))
    ref = _serve(eng, [prompt], 12)[0]
    eos = ref[3]
    eng = LlamaServingEngine(
        EngineConfig(model=MC, device="cpu", eos_token=eos, **BASE),
        params=params)
    out = _serve(eng, [prompt], 12)[0]
    assert out == ref[: ref.index(eos) + 1]
    assert eng.pool.free_pages == eng.cfg.num_pages


def test_engine_preemption_token_exact(params):
    """An oversubscribed pool preempts the youngest sequence and recomputes
    it later; the tokens are those of a roomy pool and no page leaks."""
    prompts = _prompts(7, (6, 6, 6))
    outs = {}
    for pages in (64, 5):
        cfg = EngineConfig(model=MC, device="cpu", max_batch=3,
                           num_pages=pages, page_size=8, max_seq_len=32,
                           greedy=True)
        eng = LlamaServingEngine(cfg, params=params)
        outs[pages] = _serve(eng, prompts, 10, max_steps=300)
        assert eng.pool.free_pages == cfg.num_pages
        if pages == 5:
            assert eng.preemptions > 0
    assert outs[5] == outs[64]


def test_engine_sampled_decoding_is_seeded(params):
    cfg = EngineConfig(model=MC, device="cpu", **{**BASE, "greedy": False})
    runs = []
    for _ in range(2):
        eng = LlamaServingEngine(cfg, params=params, seed=5)
        runs.append(_serve(eng, _prompts(4, (5, 7)), 6))
    assert runs[0] == runs[1]
    assert all(0 <= t < MC.vocab_size for o in runs[0] for t in o)


def test_engine_single_sequence_exceeding_pool_raises(params):
    cfg = EngineConfig(model=MC, device="cpu", max_batch=2, num_pages=2,
                       page_size=8, max_seq_len=32, greedy=True)
    eng = LlamaServingEngine(cfg, params=params)
    eng.add_request(list(range(20)), 4)
    with pytest.raises(ValueError, match="never"):
        eng.step()


@pytest.mark.parametrize("change", [
    dict(weight_dtype="fp4"), dict(weight_dtype="bf16")])
def test_outside_the_slice_raises(params, change):
    """Every weight_dtype of JAX's engine is served ("model", "fp8_e4m3",
    "int8": tests/test_torch_weights.py); any other raises JAX's
    ValueError."""
    cfg = dataclasses.replace(
        EngineConfig(model=MC, device="cpu", **BASE), **change)
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        LlamaServingEngine(cfg, params=params)


@pytest.mark.parametrize("page_size", [4, 12])
def test_page_size_not_a_multiple_of_8_raises(params, page_size):
    """Pages under 8 tokens raise JAX's ValueError (JAX's engine refuses
    them: a repacked plan's regime). A page of 12 tokens, not a multiple of
    8, no longer raises: the paged kernel reads it in place, so the plan is
    the caller's pages and the decode step's graph takes its blob alone
    (its tokens against JAX's: tests/test_torch_pages.py)."""
    cfg = dataclasses.replace(
        EngineConfig(model=MC, device="cpu", **BASE), page_size=page_size)
    if page_size < 8:
        with pytest.raises(ValueError, match="must be >= 8, got 4"):
            LlamaServingEngine(cfg, params=params)
        return
    eng = LlamaServingEngine(cfg, params=params)
    assert _serve(eng, _prompts(5, (13,)), 2)[0]
    assert eng.pool.free_pages == cfg.num_pages
