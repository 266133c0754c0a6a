"""The Llama engine on pages of 12 and 20 tokens, sizes JAX's engine serves
(any page_size >= 8) and the paged kernel reads in place (its gather
build on the card, its plain version here): greedy tokens identical to
JAX's engine at LlamaConfig.tiny() in f32 with JAX's seed-0 weights, in
both KV layouts and every KV container, and the plan is the caller's
pages (no repack), so the decode step's graph takes its blob alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops.attention.kernels.paged import (
    batch_paged_attention_run,
)
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    LlamaServingEngine,
)

MC_JAX = jax_llama.LlamaConfig.tiny()
MC = LlamaConfig.tiny()
BASE = dict(max_batch=4, num_pages=64, max_seq_len=128, greedy=True)
# JAX's engine at page 12 on these prompts, "model" KV (its tokens here)
JAX_PAGE12_TOKENS = [[23, 210, 116, 14, 73], [97, 207, 87, 5, 182],
                     [66, 184, 54, 140, 49]]


@pytest.fixture(scope="module")
def np_params():
    params = jax_llama.llama_init_weights(jax.random.key(0), MC_JAX)
    return {k: np.asarray(v) for k, v in params.items()}


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, MC.vocab_size, n).tolist() for n in (9, 4, 21)]


def _serve(eng, prompts, n_new):
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion(max_steps=100)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("page_size", [12, 20])
def test_greedy_tokens_match_jax_engine_at_odd_pages(np_params, page_size,
                                                     kv_dtype):
    """Three requests of one to three pages, prefilled together and
    decoded as one batch, NHD and HND."""
    prompts = _prompts()
    jcfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                   kv_dtype=kv_dtype, kv_scale=0.3,
                                   page_size=page_size, **BASE)
    jeng = jax_engine.LlamaServingEngine(
        jcfg, params={k: jnp.asarray(v) for k, v in np_params.items()})
    want = _serve(jeng, prompts, 5)
    if page_size == 12 and kv_dtype == "model":
        assert want == JAX_PAGE12_TOKENS
    params = params_from_numpy(np_params, device="cpu")
    for layout in ("NHD", "HND"):
        cfg = EngineConfig(model=MC, device="cpu", kv_dtype=kv_dtype,
                           kv_scale=0.3, kv_layout=layout,
                           page_size=page_size, **BASE)
        eng = LlamaServingEngine(cfg, params=params)
        before = batch_paged_attention_run.gather_launches
        assert _serve(eng, prompts, 5) == want, (layout, kv_dtype)
        assert eng.pool.free_pages == cfg.num_pages
        # CPU tensors take the plain version: no launch of either build
        assert batch_paged_attention_run.gather_launches == before


def test_engine_plans_the_callers_pages():
    """At page 12 the engine's prefill and decode plans address the
    caller's pages (no synthetic cache, no gather map), as at page 16."""
    cfg = EngineConfig(model=MC, device="cpu", page_size=12, **BASE)
    eng = LlamaServingEngine(cfg, seed=0)
    eng.add_request(list(range(1, 30)), 3)
    eng.step()  # prefill
    eng.step()  # decode
    for w in (eng._prefill_wrapper, eng._decode_wrapper):
        dp = w.device_plan
        assert dp.meta.page_size == 12 and dp.repack is None
