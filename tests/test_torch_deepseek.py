"""The DeepSeek model, f32 tiny config: the port (plain versions of the
kernels on the CPU) against the JAX package with its own parameters
(``params_from_numpy``), the paged decode step on the Pallas MLA kernel in
interpret mode, as tests/test_model_families.py drives it; the port's side
runs ``chip_smoke.deepseek_serve``, the loop that serves DeepSeek on the
card.

Tolerances: logits to 2e-4 (f32 throughout; matmuls, softmax and the MoE
sum in other orders) with the same greedy tokens; on the e4m3 path the
cache bits agree with JAX's int8 containers at >= 99.9% (a roped value on
an e4m3 rounding boundary can land one step apart after f32 matmuls in
another order) and the logits within 0.1 of JAX's e4m3 logits (the bound
JAX's own test holds its e4m3 logits to against f32)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flashinfer_tpu.models import deepseek as jax_ds
from flashinfer_tpu.ops.attention.mla import (
    BatchMLAPagedAttentionWrapper as JaxMLA,
)
from flashinfer_tpu.ops.rope import rope_cos_sin_cache as jax_cos_sin
from flashinfer_tpu_torch.models import deepseek as ds

B, S = 2, 3
PS = chip_smoke.MLA_PAGE
KV_SCALE = 0.25


@pytest.fixture(scope="module")
def model():
    jcfg = jax_ds.DeepSeekConfig.tiny()
    # one compiled call: the same function, a third of the eager time
    jparams = jax.jit(jax_ds.deepseek_init_weights, static_argnums=1)(
        jax.random.key(0), jcfg)
    params = ds.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, ds.DeepSeekConfig.tiny(), params


def test_config_mirrors_jax(model):
    jcfg, want, cfg, _ = model
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "head_dim_ckv", "head_dim_kpe", "head_dim_qk_nope",
              "num_experts", "num_shared_experts", "top_k", "moe_inter_size",
              "n_group", "topk_group", "routed_scaling_factor", "rope_theta",
              "rms_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    got = ds.deepseek_init_weights(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k


def test_forward_dense_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 6))
    want = jax_ds.deepseek_forward_dense(jparams, jnp.asarray(tokens), jcfg)
    got = ds.deepseek_forward_dense(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _decode_jax(jcfg, jparams, prompts, fp8, cos_sin):
    """tests/test_model_families.py's loop: prefill token by token, request
    b on page b (the order in which ``deepseek_serve``'s page pool hands
    out pages)."""
    L = jcfg.num_layers
    dt = jnp.int8 if fp8 else jnp.float32
    ckv = jnp.zeros((L, B, PS, jcfg.head_dim_ckv), dt)
    kpe = jnp.zeros((L, B, PS, jcfg.head_dim_kpe), dt)
    indptr = np.arange(B + 1, dtype=np.int32)
    indices = np.arange(B, dtype=np.int32)
    sm = 1.0 / math.sqrt(jcfg.head_dim_qk_nope + jcfg.head_dim_kpe)
    logits = None
    for t in range(S):
        w = JaxMLA(backend="pallas")
        w.plan(np.arange(B + 1), indptr, indices, np.full(B, t + 1),
               jcfg.num_heads, jcfg.head_dim_ckv, jcfg.head_dim_kpe, PS,
               causal=False, sm_scale=sm)
        logits, ckv, kpe = jax_ds.deepseek_decode_step(
            jparams, jcfg, jnp.asarray(prompts[:, t], jnp.int32),
            jnp.full((B,), t, jnp.int32), ckv, kpe, jnp.asarray(indices),
            jnp.asarray(indptr), jnp.full((B,), t + 1, jnp.int32), w,
            interpret=True, kv_scale=KV_SCALE if fp8 else 1.0,
            cos_sin_cache=cos_sin)
    return np.asarray(logits), np.asarray(ckv), np.asarray(kpe)


def _decode_port(cfg, params, prompts, kv):
    """The same loop through chip_smoke's serving loop on the CPU: the
    last step's logits and the caches."""
    run = chip_smoke.deepseek_serve(torch, np, cfg, params, prompts.tolist(),
                                    1, device="cpu", sampled=False, kv=kv,
                                    kv_scale=KV_SCALE)
    return run["logits"].numpy(), run["ckv"], run["kpe"]


def test_decode_step_matches_jax_and_dense(model):
    jcfg, jparams, cfg, params = model
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    want, _, _ = _decode_jax(jcfg, jparams, prompts, False, None)
    got, _, _ = _decode_port(cfg, params, prompts, "model")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    dense = ds.deepseek_forward_dense(params, torch.from_numpy(prompts), cfg)
    np.testing.assert_allclose(got, dense[:, -1].numpy(), rtol=2e-4,
                               atol=2e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_e4m3_decode_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    want, want_ckv, want_kpe = _decode_jax(
        jcfg, jparams, prompts, True,
        jax_cos_sin(64, jcfg.head_dim_kpe, rope_theta=jcfg.rope_theta))
    got, ckv, kpe = _decode_port(cfg, params, prompts, "e4m3")
    assert ckv.dtype == torch.float8_e4m3fn
    for g, w in ((ckv, want_ckv), (kpe, want_kpe)):
        same = np.mean(g.view(torch.int8).numpy() == w)
        assert same >= 0.999, same
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.1)


def test_e4m3_witness_on_cpu(model):
    """chip_smoke's e4m3 witness on the tiny model: the e4m3 path and the
    f32 path fed the e4m3 values agree (one cached key: attention returns
    its c_kv), and the records cover every layer."""
    _, _, cfg, params = model
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 2))
    out = chip_smoke.deepseek_e4m3_witness(torch, np, cfg, params,
                                           prompts.tolist(), device="cpu")
    assert len(out["layers"]) == cfg.num_layers
    assert out["logits_max_abs_bc"] <= 1e-5, out
    assert out["logits_max_abs_ab"] > 0.0  # the e4m3 rounding shows
