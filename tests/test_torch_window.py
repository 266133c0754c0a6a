"""The port's decode window, ``score()``, ``calibrate_kv_scales``,
``llama_decode_step``, the plan's ``min_max_splits`` and the fixed-shape
decode step against the JAX package, at LlamaConfig.tiny() in f32 with the
JAX weights carried over by ``params_from_numpy``.

Greedy tokens are identical to the JAX engine's, token for token; logits
(``score``, ``llama_decode_step``) agree to atol 1e-4 (f32 matmuls summed
in other orders), KV scales to rtol 1e-4, plan blobs bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.ops import page as jax_page
from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.models import llama_decode_step
from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops import page as torch_page
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.serving import (
    EngineConfig,
    LlamaServingEngine,
    calibrate_kv_scales,
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


def _jax_engine(np_params, **kw):
    cfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                  **{**BASE, **kw})
    return jax_engine.LlamaServingEngine(
        cfg, params={k: jnp.asarray(v) for k, v in np_params.items()})


def _engine(params, **kw):
    return LlamaServingEngine(
        EngineConfig(model=MC, device="cpu", **{**BASE, **kw}),
        params=params)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC.vocab_size, n).tolist() for n in lens]


def _serve(eng, prompts, n_new, max_steps=300):
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion(max_steps=max_steps)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("kv_dtype", ["model", "fp8_e4m3", "int8"])
def test_window_greedy_tokens_match_jax(np_params, params, kv_dtype):
    """Window 3 over 7 new tokens (the last window is cut to the budget),
    both layouts, against the JAX engine's window 3."""
    prompts = _prompts(11, (9, 5, 2))
    kw = dict(kv_dtype=kv_dtype, kv_scale=0.3, decode_window=3)
    want = _serve(_jax_engine(np_params, **kw), prompts, 7)
    for layout in ("NHD", "HND"):
        eng = _engine(params, kv_layout=layout, **kw)
        assert _serve(eng, prompts, 7) == want, (layout, kv_dtype)
        assert eng.pool.free_pages == eng.cfg.num_pages
        assert eng.decode_steps == 6 and eng.steps == 2


def test_window_eos_rollback_matches_jax(np_params, params):
    """An eos inside a window drops the tokens after it and rolls the KV
    back: the output ends at the eos, as the JAX engine's does, and no page
    is left taken."""
    (prompt,) = _prompts(12, (4,))
    ref = _serve(_engine(params), [prompt], 12)[0]
    # the first token that has not come before and is not a window's last
    # (token 0 comes from prefill, windows of 4 then hold tokens 1-4, 5-8)
    i = next(i for i in range(2, 12)
             if ref[i] not in ref[:i] and (i - 1) % 4 != 3)
    kw = dict(eos_token=ref[i], decode_window=4, max_batch=2, num_pages=32,
              max_seq_len=64)
    want = _serve(_jax_engine(np_params, **kw), [prompt], 12)[0]
    eng = _engine(params, **kw)
    got = _serve(eng, [prompt], 12)[0]
    assert got == want == ref[: i + 1]
    assert eng.pool.free_pages == eng.cfg.num_pages


def test_window_preemption_token_exact(params):
    """Window 3 on an oversubscribed pool preempts the youngest sequence
    and recomputes it; tokens as on a roomy pool, no page leaks."""
    prompts = _prompts(7, (6, 6, 6))
    outs = {}
    for pages in (64, 5):
        eng = _engine(params, max_batch=3, num_pages=pages, max_seq_len=32,
                      decode_window=3)
        outs[pages] = _serve(eng, prompts, 10)
        assert eng.pool.free_pages == pages
        assert (eng.preemptions > 0) == (pages == 5)
    assert outs[5] == outs[64]


def test_score_matches_jax(np_params, params):
    (prompt,) = _prompts(13, (13,))
    want = _jax_engine(np_params).score(prompt)
    eng = _engine(params)
    got = eng.score(prompt)
    assert got.shape == (13, MC.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert eng.pool.free_pages == eng.cfg.num_pages


def test_score_is_deterministic_and_leaves_requests_alone(params):
    """Two calls give the same bits; a call between a running request's
    steps does not change its tokens; a full pool raises."""
    p_run, p_score = _prompts(14, (7, 11))
    ref = _serve(_engine(params), [p_run], 6)[0]
    eng = _engine(params)
    req = eng.add_request(p_run, 6)
    eng.step()
    a = eng.score(p_score)
    eng.step()
    np.testing.assert_array_equal(a, eng.score(p_score))
    eng.run_to_completion()
    assert req.output == ref
    full = _engine(params, num_pages=2)
    with pytest.raises(RuntimeError, match="exhausted"):
        full.score(list(range(20)))
    assert full.pool.free_pages == 2


@pytest.mark.parametrize("kv_dtype", ["fp8_e4m3", "int8"])
def test_calibrate_kv_scales_matches_jax(np_params, params, kv_dtype):
    prompts = _prompts(15, (9, 17, 4))
    jcfg = jax_engine.EngineConfig(model=MC_JAX, interpret=True,
                                   kv_dtype=kv_dtype, **BASE)
    want = jax_engine.calibrate_kv_scales(
        jcfg, prompts, params={k: jnp.asarray(v)
                               for k, v in np_params.items()})
    got = calibrate_kv_scales(
        EngineConfig(model=MC, device="cpu", kv_dtype=kv_dtype, **BASE),
        prompts, params=params)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_llama_decode_step_matches_jax(np_params, params):
    """Three requests of 5, 12 and 17 tokens, the last of each appended
    this step, NHD caches [L, pages, 8, kvh, d] of random f32; each
    package's decode wrapper and append op injected."""
    rng = np.random.default_rng(16)
    L, ps, hkv, d = MC.num_layers, 8, MC.num_kv_heads, MC.head_dim
    kv = np.asarray([5, 12, 17])
    npages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)]).astype(np.int32)
    pages = int(indptr[-1]) + 2
    indices = rng.permutation(pages)[: indptr[-1]].astype(np.int32)
    last = ((kv - 1) % ps + 1).astype(np.int32)
    caches = [rng.standard_normal((L, pages, ps, hkv, d)).astype(np.float32)
              for _ in range(2)]
    tokens = rng.integers(0, MC.vocab_size, 3).astype(np.int32)
    positions = (kv - 1).astype(np.int32)
    batch_idx = np.arange(3, dtype=np.int32)
    plan_args = (indptr, indices, last, MC.num_qo_heads, hkv, d, ps)

    jw = jax_batch.BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD",
                                                      backend="reference")
    jw.plan(*plan_args, kv_chunk_size=16)
    ja = [jnp.asarray(a) for a in (batch_idx, positions, indices, indptr,
                                   last)]
    want, (wk, wv) = jax_llama.llama_decode_step(
        {k: jnp.asarray(v) for k, v in np_params.items()}, MC_JAX,
        jnp.asarray(tokens), jnp.asarray(positions),
        tuple(jnp.asarray(c) for c in caches), ja[2], ja[3], ja[4],
        lambda layer, q, kc, vc: jw.run(q, (kc, vc)),
        lambda layer, k, v, kc, vc: jax_page.append_paged_kv_cache(
            k, v, ja[0], ja[1], (kc, vc), ja[2], ja[3], ja[4]))

    tw = torch_batch.BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD",
                                                        device="cpu")
    tw.plan(*plan_args, kv_chunk_size=16)
    ta = [torch.from_numpy(a) for a in (batch_idx, positions, indices,
                                        indptr, last)]
    got, (gk, gv) = llama_decode_step(
        params, MC, torch.from_numpy(tokens), ta[1],
        tuple(torch.from_numpy(c.copy()) for c in caches), ta[2], ta[3],
        ta[4], lambda layer, q, kc, vc: tw.run(q, (kc, vc)),
        lambda layer, k, v, kc, vc: torch_page.append_paged_kv_cache(
            k, v, ta[0], ta[1], (kc, vc), ta[2], ta[3], ta[4]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_plan_min_max_splits_blob_matches_jax():
    """A decode plan whose merge is floored at 4 splits (its requests need
    at most 2), kept on the host: the reference's blob, bit for bit."""
    kv = np.asarray([40, 7, 0, 19])
    npages = -(-kv // 8)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    indices = np.zeros(16, np.int32)
    indices[: indptr[-1]] = np.random.default_rng(17).permutation(
        16)[: indptr[-1]]
    last = np.where(kv > 0, (kv - 1) % 8 + 1, 0)
    args = (indptr, indices, last, 4, 2, 32, 8)
    kw = dict(kv_len_arr=kv, kv_chunk_size=32, work_capacity=8,
              min_max_splits=4, defer_upload=True)
    jw = jax_batch.BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD")
    jw.plan(*args, **kw)
    tw = torch_batch.BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD",
                                                        device="cpu")
    tw.plan(*args, **kw)
    want, got = jw.device_plan, tw.device_plan
    assert got.meta.max_splits == 4
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    np.testing.assert_array_equal(got.blob.numpy(), np.asarray(want.blob))


@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_idle_slots_write_only_the_scratch_row(params, layout):
    """A decode step with two of four slots live writes each live slot's
    entry of its page in every layer, and the idle slots' K/V go to the
    scratch row after the cache's pages; nothing else changes."""
    eng = _engine(params, kv_layout=layout)
    reqs = [eng.add_request(p, 4) for p in _prompts(18, (6, 10))]
    eng.step()  # prefill and the first decode
    eng._k_rows[eng._scratch_row] = 0  # the first decode wrote it already
    eng._v_rows[eng._scratch_row] = 0
    k0, v0 = eng._k_rows.clone(), eng._v_rows.clone()
    eng.step()
    P, ps = eng.cfg.num_pages, eng.cfg.page_size
    want = set()
    for r in reqs:
        pos = eng.pool.seq_len(r._seq) - 1
        page = int(eng.pool.pages(r._seq)[pos // ps])
        want |= {(layer * P + page, pos % ps)
                 for layer in range(MC.num_layers)}
    want.add((eng._scratch_row, 0))
    entry_dim = 2 if layout == "HND" else 1
    for before, after in ((k0, eng._k_rows), (v0, eng._v_rows)):
        changed = (before != after).movedim(entry_dim, 1).flatten(2).any(-1)
        assert set(map(tuple, changed.nonzero().tolist())) == want
