"""The Mixtral model, tiny config: the port (plain versions of the kernels
on the CPU) against the JAX package with its own parameters
(``params_from_numpy``). The decode loops run through
``chip_smoke._token_loop``, the loop that serves Mixtral on the card: the
port's side is ``chip_smoke.mixtral_serve``, JAX's side the same loop
around JAX's ``mixtral_decode_step`` on the Pallas paged kernel in
interpret mode, as tests/test_model_families.py drives it, at pages of 8
(the port refuses pages smaller than 8; JAX's test uses 4).

Tolerances: f32 dense logits to 2e-5 (matmuls and softmax summed in other
orders); f32 decode logits to 2e-4, JAX's own tolerance for its decode
against its dense forward, with the same argmax. bf16: the dense forwards
round at the same points and agree to one bf16 step (2^-8) of the largest
logit. The decode steps differ where attention rounds P to bf16: JAX
against each sub-tile's running maximum, the port's plain version against
the ceiling of the chunk's base-2 maximum (ROADMAP Queue 3), which moves
an attention output by about a bf16 step; through two layers' norms,
matmuls and routing weights that reached 0.051 of the largest logit over
20 seeded prompt sets when this bound was set (0.0075 at the seed used
here), so bf16 decode logits are held to 2^-4 of their largest magnitude,
with the same argmax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flashinfer_tpu.models import mixtral as jax_mx
from flashinfer_tpu.ops.attention.batch import (
    BatchDecodeWithPagedKVCacheWrapper as JaxDecode,
)
from flashinfer_tpu_torch.models import mixtral as mx

PS = 8  # the port's smallest page
B, S = 2, 4  # tests/test_model_families.py:test_mixtral_decode_matches_dense

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _build(name):
    jdt, tdt = _DTYPES[name]
    jcfg = jax_mx.MixtralConfig.tiny(dtype=jdt)
    # one compiled call: the same function, a fraction of the eager time
    jparams = jax.jit(jax_mx.mixtral_init_weights, static_argnums=1)(
        jax.random.key(1), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    params = mx.params_from_numpy(np_params, device="cpu")
    return name, jcfg, jparams, np_params, mx.MixtralConfig.tiny(tdt), params


@pytest.fixture(scope="module", params=list(_DTYPES))
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def model_f32():
    return _build("f32")


def _jax_forward(jcfg, jparams, prompts, n_new):
    """A ``_token_loop`` forward around JAX's decode step: its own caches
    (the pool's pages, NHD) and a planned JAX decode wrapper a step."""
    shape = (jcfg.num_layers, chip_smoke._pages_needed(prompts, n_new, PS),
             PS, jcfg.num_kv_heads, jcfg.head_dim)
    state = {"kv": (jnp.zeros(shape, jcfg.dtype),
                    jnp.zeros(shape, jcfg.dtype))}

    def forward(toks, t, indptr, indices, last, tabs):
        n = len(toks)
        w = JaxDecode(kv_layout="NHD", backend="pallas")
        w.plan(indptr, indices, last, jcfg.num_qo_heads, jcfg.num_kv_heads,
               jcfg.head_dim, PS)
        logits, state["kv"] = jax_mx.mixtral_decode_step(
            jparams, jcfg, jnp.asarray(toks.numpy(), jnp.int32),
            jnp.full((n,), t, jnp.int32), state["kv"], jnp.asarray(indices),
            jnp.asarray(indptr), jnp.asarray(last), w, interpret=True)
        return torch.from_numpy(np.array(logits))

    return forward


def _serve_jax(jcfg, jparams, prompts, n_new):
    return chip_smoke._token_loop(
        torch, np, prompts, n_new, PS,
        _jax_forward(jcfg, jparams, prompts, n_new), device="cpu",
        sampled=False)


def _serve_port(cfg, params, prompts, n_new):
    return chip_smoke.mixtral_serve(torch, np, cfg, params, prompts, n_new,
                                    device="cpu", sampled=False,
                                    page_size=PS, chunk=PS)


def _assert_logits(name, got, want):
    if name == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=2**-4 * scale)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_config_and_weights_mirror_jax(model):
    _, jcfg, jparams, _, cfg, _ = model
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert mx.MixtralConfig() == dataclasses.replace(
        mx.MixtralConfig(), vocab_size=32000, hidden_size=4096,
        num_layers=32, num_qo_heads=32, num_kv_heads=8, head_dim=128,
        num_experts=8, top_k=2, moe_inter_size=14336, rope_theta=1e6,
        rms_eps=1e-5, dtype=torch.bfloat16)
    got = mx.mixtral_init_weights(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    assert set(got) == set(jparams)
    for k in got:
        assert tuple(got[k].shape) == tuple(jparams[k].shape), k
        assert got[k].dtype == cfg.dtype, k


def test_params_from_numpy_round_trip(model):
    _, _, _, np_params, cfg, params = model
    for k, arr in np_params.items():
        t = params[k]
        assert t.dtype == cfg.dtype and tuple(t.shape) == arr.shape, k
        if arr.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16)), k
        else:
            assert np.array_equal(t.numpy(), arr), k


def test_forward_dense_matches_jax(model):
    name, jcfg, jparams, _, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 6))
    want = np.asarray(jax_mx.mixtral_forward_dense(
        jparams, jnp.asarray(tokens), jcfg))
    got = mx.mixtral_forward_dense(params, torch.from_numpy(tokens),
                                   cfg).numpy()
    if name == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2**-8 * float(np.abs(want).max()))


def test_decode_step_matches_jax_and_dense(model):
    """JAX's test loop (prefill token by token, position t at step t) at
    pages of 8: the last step's logits, port against JAX and against the
    port's dense forward over the prompt."""
    name, jcfg, jparams, _, cfg, params = model
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want = _serve_jax(jcfg, jparams, prompts.tolist(), 1)["logits"].numpy()
    run = _serve_port(cfg, params, prompts.tolist(), 1)
    got = run["logits"].numpy()
    _assert_logits(name, got, want)
    dense = mx.mixtral_forward_dense(params, torch.from_numpy(prompts), cfg)
    _assert_logits(name, got, dense[:, -1].numpy())
    # the caches came back written in place, one token a position
    k = run["k"]
    assert k.shape[0] == cfg.num_layers and bool(k[:, :, :S].any())


def test_serve_greedy_tokens_match_jax(model_f32):
    """``chip_smoke.mixtral_serve``'s greedy tokens equal JAX's over prompts
    of different lengths (requests leave the batch as they finish), in f32:
    in bf16 the logits are held to a tolerance, and a near tie may pick
    another token."""
    _, jcfg, jparams, _, cfg, params = model_f32
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 3)]
    want = _serve_jax(jcfg, jparams, prompts, 3)["outs"]
    got = _serve_port(cfg, params, prompts, 3)["outs"]
    assert got == want
    assert all(len(o) == 3 for o in got)
