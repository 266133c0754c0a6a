"""The port's speculative decoding against the JAX package, at
LlamaConfig.tiny() in f32 with the JAX weights carried over by
``params_from_numpy`` and JAX's Pallas kernels in interpret mode.

Greedy spec tokens are identical to the JAX spec engine's, token for
token, and to the port's own non-spec engine; the engines are stepped
together, and after every step the sequences' KV lengths (the rollback)
and the verify plan's blob (bit for bit) are JAX's. ``propose_ngram`` is
JAX's function on every context tried. ``chain_speculative_sampling``
draws its uniforms from its own seed (not ``jax.random``), so it is held
to JAX where the outcome is certain, and to the target distribution by a
chi-square bound elsewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.ops import sampling as jax_sampling
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops.sampling import (
    chain_speculative_sampling,
    spec_uniforms,
)
from flashinfer_tpu_torch.serving import (
    EngineConfig,
    LlamaServingEngine,
    propose_ngram,
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


def _repetitive_prompts(seed):
    """Prompts that repeat a core (the n-gram proposer's hits, as the JAX
    spec test builds them) beside one that does not."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, MC.vocab_size, 4).tolist()
    return [core * 3, core * 2 + core[:2],
            rng.integers(0, MC.vocab_size, 5).tolist()]


def _serve(eng, prompts, n_new, max_steps=300):
    reqs = [eng.add_request(p, n) for p, n in zip(prompts, n_new)]
    eng.run_to_completion(max_steps=max_steps)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _lockstep(jeng, eng, prompts, n_new):
    """Step both engines together; after each step the emitted tokens, the
    requests that hold a sequence (preempted ones hold none), their KV
    lengths and the verify plan's blob agree."""
    jreqs = [jeng.add_request(p, n) for p, n in zip(prompts, n_new)]
    reqs = [eng.add_request(p, n) for p, n in zip(prompts, n_new)]
    steps = 0
    while jeng.has_work():
        assert eng.step() == jeng.step()
        assert [r.done for r in reqs] == [jr.done for jr in jreqs]
        assert [r._seq < 0 for r in reqs] == [jr._seq < 0 for jr in jreqs]
        running = [(jr, r) for jr, r in zip(jreqs, reqs)
                   if not jr.done and jr._seq >= 0]
        assert ([eng.pool.seq_len(r._seq) for _, r in running]
                == [jeng.pool.seq_len(jr._seq) for jr, _ in running])
        np.testing.assert_array_equal(
            eng._spec_wrapper.device_plan.blob.numpy(),
            np.asarray(jeng._spec_wrapper.device_plan.blob))
        steps += 1
        assert steps < 100
    assert not eng.has_work()
    return [r.output for r in reqs]


@pytest.mark.parametrize("kv_dtype,layouts", [
    ("model", ("NHD", "HND")), ("fp8_e4m3", ("NHD",)), ("int8", ("NHD",))])
def test_spec_greedy_tokens_match_jax(np_params, params, kv_dtype, layouts):
    """spec_tokens 3 on four slots (one idle): the JAX spec engine's tokens
    and, step by step, its KV lengths and verify blobs; the port's
    non-spec engine's tokens in no more steps; drafts accepted."""
    prompts, n_new = _repetitive_prompts(5), [8, 6, 7]
    kw = dict(kv_dtype=kv_dtype, kv_scale=0.3)
    jeng = _jax_engine(np_params, spec_tokens=3, **kw)
    eng = _engine(params, spec_tokens=3, **kw)
    want = _lockstep(jeng, eng, prompts, n_new)
    assert eng.spec_stats["accepted"] > 0
    base = _engine(params, **kw)
    assert _serve(base, prompts, n_new) == want
    assert eng.steps <= base.steps
    for layout in layouts[1:]:
        other = _engine(params, spec_tokens=3, kv_layout=layout, **kw)
        assert _serve(other, prompts, n_new) == want, layout
        assert other.pool.free_pages == BASE["num_pages"]


def test_spec_rollback_after_eos_and_cap_matches_jax(np_params, params):
    """Three slots of spec_tokens 3 (12 verify rows in a bucket of 16: the
    dummy request takes 4 pad rows). Request 1 stops at an eos, and
    request 0's budget of 9 cuts a verify row of four kept tokens after
    two: after every step the KV lengths and tokens are the JAX engine's,
    and the tokens those of the non-spec engine, cut."""
    prompts = _repetitive_prompts(9)
    ref = _serve(_engine(params, max_batch=3), prompts, [12] * 3)
    eos = ref[1][10]
    assert ref[1].index(eos) == 10 and eos not in ref[0] + ref[2]
    n_new = [9, 12, 8]
    kw = dict(max_batch=3, spec_tokens=3, eos_token=eos)
    eng = _engine(params, **kw)
    got = _lockstep(_jax_engine(np_params, **kw), eng, prompts, n_new)
    assert got == [ref[0][:9], ref[1][:11], ref[2][:8]]
    assert eng._spec_wrapper.device_plan.meta.nnz == 16
    assert eng.pool.free_pages == BASE["num_pages"]


def test_spec_preemption_token_exact(np_params, params):
    """An oversubscribed pool (5 pages for three sequences of 2) preempts
    during spec steps: stepped together with the JAX spec engine on the
    same pool, every step's tokens, KV lengths and verify blob are JAX's,
    and the tokens are those of a roomy pool (64 pages), as JAX's
    test_engine_preemption_token_exact[spec] holds them."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, MC.vocab_size, 6).tolist() for _ in range(3)]
    kw = dict(max_batch=3, max_seq_len=32, spec_tokens=2)
    roomy = _engine(params, num_pages=64, **kw)
    want = _serve(roomy, prompts, [10] * 3)
    assert roomy.pool.free_pages == 64 and roomy.preemptions == 0
    jeng = _jax_engine(np_params, num_pages=5, **kw)
    eng = _engine(params, num_pages=5, **kw)
    assert _lockstep(jeng, eng, prompts, [10] * 3) == want
    assert eng.preemptions == jeng.preemptions > 0
    assert eng.pool.free_pages == 5


def test_spec_sampled_engine_is_seeded(params):
    """Sampled spec decoding: valid ids, exact counts, and the same seed
    draws the same tokens."""
    prompts = _repetitive_prompts(8)
    cfg = EngineConfig(model=MC, device="cpu", **{
        **BASE, "greedy": False, "temperature": 0.8, "spec_tokens": 2})
    runs = [_serve(LlamaServingEngine(cfg, params=params, seed=3), prompts,
                   [6, 4, 5]) for _ in range(2)]
    assert runs[0] == runs[1]
    assert [len(o) for o in runs[0]] == [6, 4, 5]
    assert all(0 <= t < MC.vocab_size for o in runs[0] for t in o)


def test_spec_ngram_is_the_proposers_n(params, monkeypatch):
    """``EngineConfig.spec_ngram`` reaches ``propose_ngram``."""
    from flashinfer_tpu_torch.serving import engine as torch_engine

    seen = []

    def record(ctx, num_spec, max_ngram):
        seen.append((num_spec, max_ngram))
        return propose_ngram(ctx, num_spec, max_ngram)

    monkeypatch.setattr(torch_engine, "propose_ngram", record)
    eng = _engine(params, spec_tokens=2, spec_ngram=5)
    _serve(eng, _repetitive_prompts(9)[:1], [3])
    assert seen and set(seen) == {(2, 5)}
    assert EngineConfig(model=MC).spec_ngram == \
        jax_engine.EngineConfig(model=MC_JAX).spec_ngram


def test_propose_ngram_matches_jax():
    cases = [([7, 8, 9, 1, 2, 7, 8], 3, 3), ([5, 6, 1, 5, 6], 3, 2),
             ([1, 2, 3], 2, 3), ([4], 2, 3)]
    want = [[9, 1, 2], [1, 5, 6], [3, 3], [4, 4]]
    assert [propose_ngram(*c) for c in cases] == want
    rng = np.random.default_rng(10)
    for _ in range(300):
        ctx = rng.integers(0, int(rng.integers(2, 6)),
                           int(rng.integers(1, 40))).tolist()
        g, n = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        assert propose_ngram(ctx, g, n) == jax_engine.propose_ngram(ctx, g,
                                                                    n)


def _chain_case(rng, batch, num_spec, vocab, outcome):
    """Drafts and targets whose verification is certain: ``accept`` puts
    at least the draft's probability on every draft token, ``reject`` puts
    0 on the first one."""
    draft = rng.dirichlet(np.ones(vocab), (batch, num_spec)).astype(
        np.float32)
    target = rng.dirichlet(np.ones(vocab), (batch, num_spec + 1)).astype(
        np.float32)
    ids = rng.integers(0, vocab, (batch, num_spec))
    for b in range(batch):
        for j in range(num_spec):
            t = ids[b, j]
            if outcome == "accept":
                target[b, j, t] = max(target[b, j, t], draft[b, j, t])
            elif j == 0:
                target[b, 0] = np.where(np.arange(vocab) == t, 0.0,
                                        target[b, 0] + 0.01)
    target /= target.sum(-1, keepdims=True)
    if outcome == "accept":  # renormalising may lower a raised entry
        for b in range(batch):
            for j in range(num_spec):
                draft[b, j, ids[b, j]] = min(draft[b, j, ids[b, j]],
                                             target[b, j, ids[b, j]])
    return draft, ids.astype(np.int32), target


@pytest.mark.parametrize("outcome", ["accept", "reject"])
def test_chain_speculative_sampling_certain_outcomes_match_jax(outcome):
    rng = np.random.default_rng(11)
    draft, ids, target = _chain_case(rng, 6, 3, 12, outcome)
    w_out, w_acc, w_emit = (np.asarray(a) for a in
                            jax_sampling.chain_speculative_sampling(
                                jnp.asarray(draft), jnp.asarray(ids),
                                jnp.asarray(target), jax.random.key(3)))
    for seed in (0, 7, -1):
        out, acc, emit = (a.numpy() for a in chain_speculative_sampling(
            torch.from_numpy(draft), torch.from_numpy(ids),
            torch.from_numpy(target), seed=seed))
        np.testing.assert_array_equal(acc, w_acc)
        np.testing.assert_array_equal(emit, w_emit)
        for b, n in enumerate(acc):
            np.testing.assert_array_equal(out[b, :n], w_out[b, :n])
            assert (out[b, n + 1:] == -1).all()
            if n < ids.shape[1]:  # resampled: in the residual's support
                resid = np.maximum(target[b, n] - draft[b, n], 0)
                assert resid[out[b, n]] > 0
            else:
                assert 0 <= out[b, n] < target.shape[-1]


def test_chain_speculative_sampling_keeps_the_target_distribution():
    """The first emitted token (a draft accepted, or the residual's draw)
    follows the target's first row: 20,000 rows of one case, each its own
    uniforms and noise, within chi-square 30 on 7 degrees of freedom (its
    0.9999 quantile is 29.9; the seed is fixed, so the test is
    deterministic)."""
    vocab, num_spec, rows = 8, 2, 20000
    rng = np.random.default_rng(12)
    draft = rng.dirichlet(np.ones(vocab), num_spec).astype(np.float32)
    target = rng.dirichlet(np.ones(vocab), num_spec + 1).astype(np.float32)
    ids = rng.choice(vocab, (rows, num_spec), p=draft[0]).astype(np.int32)
    out, _, _ = chain_speculative_sampling(
        torch.from_numpy(np.broadcast_to(draft, (rows,) + draft.shape)
                         .copy()),
        torch.from_numpy(ids),
        torch.from_numpy(np.broadcast_to(target, (rows,) + target.shape)
                         .copy()), seed=13)
    counts = np.bincount(out[:, 0].numpy(), minlength=vocab)
    expected = rows * target[0].astype(np.float64)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 30.0, (chi2, counts, expected)


def test_spec_uniforms_take_an_int_or_a_tensor_seed():
    for seed in (0, 5, -1, 2**31 - 1):
        a = spec_uniforms(seed, 4, 3)
        assert torch.equal(a, spec_uniforms(
            torch.tensor([seed], dtype=torch.int32), 4, 3))
        assert bool(((a >= 0) & (a < 1)).all())
    assert not torch.equal(spec_uniforms(0, 4, 3), spec_uniforms(1, 4, 3))


def test_engine_config_takes_the_jax_fields():
    """Every field of JAX's EngineConfig but ``interpret`` (the Pallas
    interpret switch, which has no meaning on the card) is the port's."""
    ours = {f.name for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name for f in dataclasses.fields(jax_engine.EngineConfig)}
    assert theirs - ours == {"interpret"}
