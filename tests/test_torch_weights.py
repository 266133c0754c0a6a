"""8-bit Llama weights in the port against the JAX package, at
LlamaConfig.tiny() in f32: the quantizers' bits and scales, the 8-bit
initialisers' scheme, ``params_from_numpy`` on JAX's quantized dicts, the
dense paths' refusal, and the engine's greedy tokens with
``weight_dtype`` "fp8_e4m3" and "int8" (JAX's engine in interpret mode,
the same parameters carried across).

Tolerances: bits, 8-bit values and scales are exact (the same f32 divide,
e4m3 rounding and round-half-even on both sides); greedy tokens identical;
``score()`` logits to atol 1e-4 (f32 matmuls summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.models.llama import (
    LlamaConfig,
    llama_decode_step,
    llama_forward_dense,
    llama_init_weights,
    llama_init_weights_fp8,
    llama_init_weights_int8,
    params_from_numpy,
    quantize_llama_weights_fp8,
    quantize_llama_weights_int8,
)
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    LlamaServingEngine,
)

MC_JAX = jax_llama.LlamaConfig.tiny()
MC = LlamaConfig.tiny()
BASE = dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
            greedy=True)
NAMES = ("wq", "wk", "wv", "wo", "w_gate_up", "w_down", "lm_head")
SUFFIX = {"fp8_e4m3": "_scale", "int8": "_iscale"}
JAX_QUANT = {"fp8_e4m3": jax_llama.quantize_llama_weights_fp8,
             "int8": jax_llama.quantize_llama_weights_int8}
QUANT = {"fp8_e4m3": quantize_llama_weights_fp8,
         "int8": quantize_llama_weights_int8}


@pytest.fixture(scope="module")
def np_params():
    params = jax_llama.llama_init_weights(jax.random.key(0), MC_JAX)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params, device="cpu")


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (8-bit values as uint8)."""
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return t.numpy().view(np.uint8) if t.dtype == torch.int8 else t.numpy()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC.vocab_size, n).tolist() for n in lens]


def _serve(eng, prompts, n_new, max_steps=300):
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion(max_steps=max_steps)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantizer_bits_and_scales_equal_jax(np_params, wdt, dtype):
    """Every value of every matmul weight, one at each channel's amax
    among them (448 / 127 after the divide), and every scale."""
    if dtype == "bf16":
        np_params = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                     for k, v in np_params.items()}
    want = {k: np.asarray(v) for k, v in JAX_QUANT[wdt](
        {k: jnp.asarray(v) for k, v in np_params.items()}).items()}
    got = QUANT[wdt](params_from_numpy(np_params, device="cpu"))
    assert sorted(got) == sorted(want)
    for name in NAMES:
        q = got[name]
        assert q.dtype == (torch.int8 if wdt == "int8"
                           else torch.float8_e4m3fn)
        np.testing.assert_array_equal(_bytes(q), want[name].view(np.uint8))
        np.testing.assert_array_equal(got[name + SUFFIX[wdt]].numpy(),
                                      want[name + SUFFIX[wdt]])
        top = 127 if wdt == "int8" else 0x7E  # 448's code
        assert int((_bytes(q) & 0x7F).max()) == top
    np.testing.assert_array_equal(
        _bytes(got["embedding"].view(torch.uint8) if dtype == "bf16"
               else got["embedding"]).view(np.uint8),
        np_params["embedding"].view(np.uint8))


@pytest.mark.parametrize("init,wdt", [(llama_init_weights_fp8, "fp8_e4m3"),
                                      (llama_init_weights_int8, "int8")])
def test_llama_init_weights_8bit_follow_the_scheme(init, wdt):
    """JAX's test_llama_init_weights_int8_matches_quantizer, for both
    containers: the scale keys, dtypes and shapes of the quantizer, each
    channel's largest value at the top code, the embedding in the model
    dtype; and seeded."""
    p = init(torch.Generator().manual_seed(0), MC, "cpu")
    q8 = QUANT[wdt](llama_init_weights(torch.Generator().manual_seed(0), MC,
                                       "cpu"))
    for name in NAMES:
        s = p[name + SUFFIX[wdt]]
        assert s.dtype == torch.float32
        assert s.shape == q8[name + SUFFIX[wdt]].shape
        assert s.shape[-2] == 1 and s.shape[-1] == p[name].shape[-1]
        assert p[name].dtype == q8[name].dtype
        assert p[name].shape == q8[name].shape
        top = 127 if wdt == "int8" else 0x7E
        raw = _bytes(p[name])
        codes = (np.abs(raw.view(np.int8).astype(np.int32)) if wdt == "int8"
                 else raw.astype(np.int32) & 0x7F)
        assert (codes.max(axis=-2) == top).all()
    assert sorted(p) == sorted(q8)
    assert p["embedding"].dtype == MC.dtype
    again = init(torch.Generator().manual_seed(0), MC, "cpu")
    assert all(torch.equal(_t(p[k]), _t(again[k])) for k in p)


def _t(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
def test_params_from_numpy_carries_quantized_dicts(np_params, wdt):
    """JAX's int8 containers of e4m3 bits become float8_e4m3fn views of the
    same bytes; linear int8 stays int8; scales and the rest unchanged."""
    jq = {k: np.asarray(v) for k, v in JAX_QUANT[wdt](
        {k: jnp.asarray(v) for k, v in np_params.items()}).items()}
    got = params_from_numpy(jq, device="cpu")
    for name in NAMES:
        assert got[name].dtype == (torch.float8_e4m3fn if wdt == "fp8_e4m3"
                                   else torch.int8)
        np.testing.assert_array_equal(_bytes(got[name]),
                                      jq[name].view(np.uint8))
        np.testing.assert_array_equal(got[name + SUFFIX[wdt]].numpy(),
                                      jq[name + SUFFIX[wdt]])
    np.testing.assert_array_equal(got["attn_norm"].numpy(), jq["attn_norm"])


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
def test_dense_paths_refuse_quantized_params(params, wdt):
    """ValueError with JAX's reason (flashinfer_tpu/models/llama.py:104):
    the scale keys, or an 8-bit wo with the keys dropped."""
    q = QUANT[wdt](params)
    tok = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="scale keys"):
        llama_forward_dense(q, tok, MC)
    no_keys = {k: v for k, v in q.items() if not k.endswith("scale")}
    with pytest.raises(ValueError, match="8-bit weight containers"):
        llama_forward_dense(no_keys, tok, MC)
    with pytest.raises(ValueError, match="scale keys"):
        llama_decode_step(q, MC, tok[0], tok[0], (None, None), None, None,
                          None, None, None)


def _jax_engine(np_params, wdt, **kw):
    cfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                  weight_dtype=wdt, **{**BASE, **kw})
    return jax_engine.LlamaServingEngine(
        cfg, params={k: jnp.asarray(v) for k, v in np_params.items()})


def _engine(params, wdt, **kw):
    return LlamaServingEngine(
        EngineConfig(model=MC, device="cpu", weight_dtype=wdt,
                     **{**BASE, **kw}), params=params)


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("mode", [
    dict(), dict(kv_layout="HND"), dict(decode_window=4),
    dict(spec_tokens=3)], ids=["decode", "hnd", "window4", "spec3"])
def test_8bit_engine_greedy_tokens_match_jax(np_params, params, wdt, mode):
    """Four requests, prefilled together and decoded as one batch (a window
    of 4 steps, or verify steps of 3 drafts), each engine quantizing the
    same f32 weights itself; the quantized weights are JAX's."""
    prompts = _prompts(7, (9, 4, 21, 12))
    jeng = _jax_engine(np_params, wdt, **mode)
    eng = _engine(params, wdt, **mode)
    assert eng.params["wqkv" + SUFFIX[wdt]].shape == (
        MC.num_layers, 1, (MC.num_qo_heads + 2 * MC.num_kv_heads)
        * MC.head_dim)
    for name in ("wqkv", "wo", "lm_head"):
        np.testing.assert_array_equal(
            _bytes(eng.params[name]),
            np.asarray(jeng.params[name]).view(np.uint8))
    assert _serve(eng, prompts, 6) == _serve(jeng, prompts, 6)


@pytest.mark.parametrize("wdt", ["fp8_e4m3", "int8"])
def test_8bit_engine_on_jax_quantized_params(np_params, wdt):
    """JAX's quantized dict through ``params_from_numpy``, served with
    weight_dtype "model" (the keys decide, as in JAX) and with the matching
    weight_dtype: JAX's greedy tokens and ``score()`` logits."""
    jq = {k: np.asarray(v) for k, v in JAX_QUANT[wdt](
        {k: jnp.asarray(v) for k, v in np_params.items()}).items()}
    prompts = _prompts(8, (5, 17))
    jeng = _jax_engine(jq, "model")
    want = _serve(jeng, prompts, 5)
    want_score = jeng.score(prompts[1])
    p = params_from_numpy(jq, device="cpu")
    for w in ("model", wdt):
        eng = _engine(p, w)
        assert _serve(eng, prompts, 5) == want, w
        np.testing.assert_allclose(eng.score(prompts[1]), want_score,
                                   atol=1e-4, rtol=0)


def test_8bit_engine_refuses_mismatched_containers(params):
    """JAX's two container-mismatch errors (flashinfer_tpu/serving/
    engine.py:134-164), and an unknown weight_dtype."""
    with pytest.raises(ValueError, match="linear-int8"):
        _engine(quantize_llama_weights_int8(params), "fp8_e4m3")
    with pytest.raises(ValueError, match="e4m3 bits"):
        _engine(quantize_llama_weights_fp8(params), "int8")
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        _engine(params, "fp4")
