"""The Llama engine's fixed-shape prefill and ``score()`` steps (JAX's
``_prefill_step`` and ``_score_step``: rows padded to a power-of-two
bucket, the plan pinned for the bucket, one int32 input buffer a step) and
the dp x tp engine's step on its input buffer, against the JAX package at
LlamaConfig.tiny() in f32 with the JAX weights carried over by
``params_from_numpy``. On the CPU every step runs eagerly on the buffer
the card's CUDA graph reads (tests/test_torch_cuda.py holds the graphs to
these eager steps bit for bit).

Tolerances: greedy tokens are identical to the JAX engine's. Model-dtype
(f32) caches and ``score()`` logits agree to atol 1e-4 (f32 matmuls
summed in other orders, as tests/test_torch_window.py). An 8-bit cache's
layer 0 (no attention upstream) holds JAX's bytes at more than 0.999 of
the entries either package wrote (the rest sit on a rounding boundary),
and an int8 entry is within one step of JAX's. ``score()`` agrees to
atol 2e-3 over an int8 cache (such a step moves a logit by ~1e-3). Over
an e4m3 cache the two packages read the cache otherwise, on the unpadded
step before as on the padded one: JAX's bit decode flushes e4m3
subnormals to zero (ops/attention/kernels/paged.py:104 of the JAX
package), and both round P to bf16 for the P.V product, JAX as 2^(s -
max s), the port as 2^(s - ceil(max s)), the base its kernel's online
softmax takes. So an e4m3 entry of layer 1 is within one step plus 2^-4
of JAX's (measured: layer 1 holds JAX's bytes at ~0.92 of its entries,
~20 of 2176 lie more than a step apart, at most 0.031 where values reach
3.25), and ``score()`` agrees to atol 0.1 with a mean difference under
0.01 (measured: 0.054 and 0.0054).
Sampled tokens of the dp x tp engine are identical on every rank and to
the single-card engine's at (dp, tp) = (1, 2)."""

import os
import sys

import numpy as np
import pytest

KV = ("model", "fp8_e4m3", "int8")
BASE = dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
            greedy=True, kv_scale=0.3)
# admissions whose row counts are not powers of two: 34 rows (bucket 64),
# 3 (bucket 8) and 37 (bucket 64)
BATCHES = ((9, 4, 21), (3,), (13, 6, 11, 7))


@pytest.fixture(scope="module")
def np_params():
    import jax

    from flashinfer_tpu.models import llama as jax_llama

    params = jax_llama.llama_init_weights(jax.random.key(0),
                                          jax_llama.LlamaConfig.tiny())
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params(np_params):
    from flashinfer_tpu_torch.models.llama import params_from_numpy

    return params_from_numpy(np_params, device="cpu")


def _jax_engine(np_params, **kw):
    import jax.numpy as jnp

    from flashinfer_tpu.models import llama as jax_llama
    from flashinfer_tpu.serving import engine as jax_engine

    cfg = jax_engine.EngineConfig(model=jax_llama.LlamaConfig.tiny(),
                                  interpret=True, **{**BASE, **kw})
    return jax_engine.LlamaServingEngine(
        cfg, params={k: jnp.asarray(v) for k, v in np_params.items()})


def _engine(params, **kw):
    from flashinfer_tpu_torch.models.llama import LlamaConfig
    from flashinfer_tpu_torch.serving import EngineConfig, LlamaServingEngine

    return LlamaServingEngine(
        EngineConfig(model=LlamaConfig.tiny(), device="cpu",
                     **{**BASE, **kw}), params=params)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _cache_bytes(c):
    """A cache as numpy: f32 values, or the int8 bytes of an 8-bit one."""
    import torch

    if c.dtype == torch.float8_e4m3fn:
        c = c.view(torch.int8)
    return np.asarray(c)


def _e4m3_values(bits):
    import torch

    return torch.from_numpy(bits.copy()).view(
        torch.float8_e4m3fn).float().numpy()


def _same_cache(ours, ref, kv_dtype, layer_rows):
    """Model dtype: atol 1e-4. 8-bit: layer 0's entries (no attention
    upstream) hold JAX's bytes at more than 0.999 of those either package
    wrote; every entry is within one quantization step of JAX's."""
    ours, ref = _cache_bytes(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if kv_dtype == "model":
        np.testing.assert_allclose(ours, ref, atol=1e-4)
        return
    a, b = ours[:layer_rows], ref[:layer_rows]
    written = (a != 0) | (b != 0)
    assert written.any()
    assert np.mean(a[written] == b[written]) > 0.999
    if kv_dtype == "int8":
        assert np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max() <= 1
        return
    # e4m3: a step is 2^-3 of the value's binade, plus 2^-4 for what
    # JAX's other reading of layer 0 moves in layer 1 (module docstring)
    x, y = _e4m3_values(ours), _e4m3_values(ref)
    step = np.maximum(np.abs(x), np.abs(y)) * 2.0 ** -3 + 2.0 ** -4
    assert (np.abs(x - y) <= step).all()


@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_padded_prefill_matches_jax_prefill_step(np_params, params, kv_dtype,
                                                 layout):
    """Three admissions of 34, 3 and 37 rows (padded to 64, 8 and 64),
    each request done at its first token: after every step the tokens are
    JAX's, and every page of both caches holds what JAX's ``_prefill_step``
    wrote (so the padding rows wrote no page)."""
    jeng = _jax_engine(np_params, kv_dtype=kv_dtype, kv_layout=layout)
    eng = _engine(params, kv_dtype=kv_dtype, kv_layout=layout)
    for i, lens in enumerate(BATCHES):
        prompts = _prompts(30 + i, lens)
        outs = []
        for e in (jeng, eng):
            reqs = [e.add_request(p, 1) for p in prompts]
            e.step()
            assert not e.has_work()
            outs.append([r.output for r in reqs])
        assert outs[1] == outs[0], (lens, kv_dtype, layout)
        for ours, ref in ((eng.k_cache, jeng.k_cache),
                          (eng.v_cache, jeng.v_cache)):
            _same_cache(ours, ref, kv_dtype, eng.cfg.num_pages)


@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_padding_rows_write_only_the_scratch_row(params, layout):
    """37 prompt rows padded to 64: the 27 padding rows' K/V land in the
    scratch row after the cache's ``L * num_pages`` rows and nowhere else;
    every entry no prompt token owns keeps what it held."""
    import torch

    eng = _engine(params, kv_layout=layout)
    for rows in (eng._k_rows, eng._v_rows):
        rows.fill_(7.0)
    prompts = _prompts(40, BATCHES[2])
    reqs = [eng.add_request(p, 4) for p in prompts]
    eng._admit([])  # the prefill alone
    assert all(len(r.output) == 1 for r in reqs)
    ps, pages = eng.cfg.page_size, eng.cfg.num_pages
    owned = torch.zeros(eng._k_rows.shape[0], ps, dtype=torch.bool)
    for r, p in zip(reqs, prompts):
        indptr, indices, _ = eng.pool.batch_export([r._seq])
        for t in range(len(p)):
            page = int(indices[t // ps])
            for layer in range(eng.cfg.model.num_layers):
                owned[layer * pages + page, t % ps] = True
    for rows in (eng._k_rows, eng._v_rows):
        # [rows, entry]: whether any value of the entry changed
        by_entry = rows.transpose(1, 2) if layout == "HND" else rows
        changed = (by_entry != 7.0).flatten(2).any(dim=2)
        scratch = eng._scratch_row
        assert changed[scratch].any()
        assert torch.equal(changed[:scratch], owned[:scratch])


def _prefill_keys(eng):
    """Wrap ``_prefill_inputs`` to record the graph keys it returns."""
    keys, inputs = [], eng._prefill_inputs

    def recorded(*a, **kw):
        key, row = inputs(*a, **kw)
        keys.append(key)
        return key, row

    eng._prefill_inputs = recorded
    return keys


def test_prefill_metas_are_pinned_within_a_bucket(params):
    """Admissions of one to four requests whose rows fall in one bucket
    plan one PlanMeta (the key of one CUDA graph on the card); another
    bucket plans another. The merge's splits follow the batch: in the
    1024-row bucket a 600-token prompt (two 512-key chunks) plans the
    meta of two 300 / 250-token ones but for ``max_splits``. ``score()``
    keys its own per bucket."""
    import dataclasses

    eng = _engine(params, max_seq_len=1024, num_pages=256)
    keys = _prefill_keys(eng)
    for i, lens in enumerate(((20, 9, 30), (64,), (33, 2), (5, 6, 7, 20),
                              (70, 40), (600,), (300, 250))):
        for p in _prompts(50 + i, lens):
            eng.add_request(p, 1)
        eng.step()
    assert {k[0] for k in keys} == {"prefill"}
    assert len(set(keys[:4])) == 1 and keys[4] != keys[0]
    meta, wide = keys[0][1], keys[4][1]
    assert (meta.nnz, wide.nnz) == (64, 128)
    for m in (meta, wide):
        assert m.kv_major and m.max_splits == 1
        assert m.bucket_rows >= m.nnz * m.gqa_group
    split, whole = keys[5][1], keys[6][1]
    assert (split.nnz, split.max_splits, whole.max_splits) == (1024, 2, 1)
    assert dataclasses.replace(split, max_splits=1) == whole
    for p in _prompts(60, (40, 61, 100)):
        eng.score(p)
    score_keys = keys[7:]
    assert [k[0] for k in score_keys] == ["score"] * 3
    assert score_keys[0] == score_keys[1] != score_keys[2]


@pytest.mark.parametrize("kv_dtype", KV)
def test_score_matches_jax_score_step(np_params, params, kv_dtype):
    """``score()`` of prompts of 23 and 70 rows (buckets 32 and 128) on the
    padded step: JAX's ``_score_step`` logits of every prompt row."""
    jeng = _jax_engine(np_params, kv_dtype=kv_dtype)
    eng = _engine(params, kv_dtype=kv_dtype)
    atol, mean = dict(model=(1e-4, 1e-4), int8=(2e-3, 2e-3),
                      fp8_e4m3=(0.1, 0.01))[kv_dtype]
    for p in _prompts(70, (23, 70)):
        want = jeng.score(p)
        got = eng.score(p)
        assert got.shape == (len(p), 256) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=atol)
        assert np.abs(got - want).mean() <= mean


# --------------------------------------------------------------- dp x tp

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_qo_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)
DIST_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [3, 1]]
DIST_NEW = [6, 5, 4, 6]
SAMPLED = dict(greedy=False, top_k=8, top_p=0.9)


def _dist_config(torch, **kw):
    from flashinfer_tpu_torch.models.llama import LlamaConfig
    from flashinfer_tpu_torch.serving.engine import EngineConfig

    args = dict(dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
                     greedy=True), **kw)
    return EngineConfig(model=LlamaConfig(**MODEL, dtype=torch.float32),
                        device="cpu", **args)


def _dist_tokens(eng, **kw):
    """Serve the prompts; the tokens padded with -1 into one array."""
    reqs = [eng.add_request(p, n, **kw) for p, n in zip(DIST_PROMPTS,
                                                        DIST_NEW)]
    eng.run_to_completion(max_steps=200)
    assert all(r.done for r in reqs)
    width = max(DIST_NEW)
    return np.asarray([r.output + [-1] * (width - len(r.output))
                       for r in reqs])


def _dist_worker(outdir, rank, world):
    """One gloo rank: sampled (dp, tp) = (1, 2) and (2, 1), greedy (1, 2),
    on the step's input buffer with the seed in it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
        bootstrap_distributed,
    )

    torch.set_num_threads(1)
    bootstrap_distributed(f"file://{outdir}/store", world, rank)
    params = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    for shape, kw in (((1, 2), SAMPLED), ((2, 1), SAMPLED), ((1, 2), {})):
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("dp", "tp"))
        eng = DistributedServingEngine(_dist_config(torch, **kw), mesh,
                                       params=params, seed=3)
        name = (f"dp{shape[0]}tp{shape[1]}_"
                f"{'sampled' if kw else 'greedy'}")
        out[name] = _dist_tokens(eng)
        out[name + "_buffers"] = np.asarray(
            [int(b.numel()) for b in eng.graphs._bufs.values()])
        out[name + "_steps"] = np.asarray(eng.steps)
    np.savez(os.path.join(outdir, f"out_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_world2(np_params, tmp_path_factory):
    import jax

    from flashinfer_tpu.models.llama import LlamaConfig, llama_init_weights
    from test_torch_parallel import spawn

    import jax.numpy as jnp

    weights = llama_init_weights(jax.random.key(0),
                                 LlamaConfig(**MODEL, dtype=jnp.float32))
    weights = {k: np.asarray(v) for k, v in weights.items()}
    outs = spawn(os.path.abspath(__file__), "dist",
                 tmp_path_factory.mktemp("prefill_graphs_world2"), 2,
                 weights)
    return weights, outs


def _on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


@pytest.mark.parametrize("shape", ["dp1tp2", "dp2tp1"])
def test_dist_sampled_tokens_from_the_buffer_seed(dist_world2, shape):
    """Sampled steps with the seed in the step's input buffer: every gloo
    rank emits the same tokens, each request its budget, and one input
    buffer (one PlanMeta) serves every step."""
    _, outs = dist_world2
    toks = _on_every_rank(outs, f"{shape}_sampled")
    assert [int((row >= 0).sum()) for row in toks] == DIST_NEW
    assert (toks < MODEL["vocab_size"]).all()
    assert len(_on_every_rank(outs, f"{shape}_sampled_buffers")) == 1


@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_dist_step_matches_single_card_engine(dist_world2, mode):
    """At (dp, tp) = (1, 2) the step draws the seed the single-card engine
    draws for the same step (one a replica a step, from seed + 1) and reads
    it from its buffer: sampled and greedy tokens equal
    ``LlamaServingEngine``'s on the same weights."""
    import torch

    from flashinfer_tpu_torch.models.llama import params_from_numpy
    from flashinfer_tpu_torch.serving.engine import LlamaServingEngine

    weights, outs = dist_world2
    kw = SAMPLED if mode == "sampled" else {}
    eng = LlamaServingEngine(_dist_config(torch, **kw),
                             params=params_from_numpy(weights, "cpu"),
                             seed=3)
    np.testing.assert_array_equal(_on_every_rank(outs, f"dp1tp2_{mode}"),
                                  _dist_tokens(eng))


if __name__ == "__main__":
    _dist_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
