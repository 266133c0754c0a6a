"""The port's host runtime (the C++ planner and page pool, built by the
port's ``jit``) against the port's NumPy planner and Python pool and the
JAX package's NumPy planner and ``PagePool``.

Everything here is exact: plans equal field by field (integer arrays),
pools hand out the same page ids and export the same tables, and the tiny
Llama engine emits JAX's greedy tokens."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu import jit as jax_jit
from flashinfer_tpu.models import llama as jax_llama
from flashinfer_tpu.scheduler import plan as jax_plan
from flashinfer_tpu.scheduler.native import PagePool as JaxPagePool
from flashinfer_tpu.serving import engine as jax_engine
from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.jit import core as jit_core
from flashinfer_tpu_torch.models.llama import LlamaConfig, params_from_numpy
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.scheduler import native
from flashinfer_tpu_torch.scheduler import plan as torch_plan
from flashinfer_tpu_torch.scheduler.page_pool import PagePool as PyPagePool
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    LlamaServingEngine,
)

FIELDS = ("request_indices", "qo_tile_indices", "kv_tile_indices",
          "qo_start_row", "qo_tile_len", "kv_start", "kv_end",
          "kv_page_start", "num_kv_splits", "q_pos_base", "merge_out_row")
SCALARS = ("tile_q", "kv_chunk_size", "num_work_items", "total_rows",
           "batch_size", "page_size", "gqa_group", "num_valid_items")


def _equal(a, b):
    for f in SCALARS:
        assert int(getattr(a, f)) == int(getattr(b, f)), f
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == np.int32, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _batch(seed):
    """One seeded planner call: decode or prefill rows, GQA groups, a page
    table or the ragged identity, a fixed or derived chunk, a capacity."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 9))
    decode = seed % 3 == 0
    group = int(rng.choice([1, 2, 4, 8]))
    tile_q = int(rng.choice([8, 16, 64, 128]))
    ps = int(rng.choice([1, 8, 16]))
    tok = np.ones(b, np.int64) if decode else rng.integers(0, 300, b)
    kv = tok + rng.integers(0, 3000, b)
    rows = -(-(tok * group) // tile_q) * tile_q
    qo_indptr = np.concatenate([[0], np.cumsum(rows)])
    kw = dict(qo_token_lens=tok, gqa_group=group, page_size=ps,
              tile_q=tile_q, causal=bool(seed % 2))
    if seed % 4 != 1:
        pages = -(-kv // ps)
        kw["kv_indptr"] = np.concatenate([[0], np.cumsum(pages)])
    if seed % 5 in (0, 2):
        kw["kv_chunk_size"] = int(rng.choice([64, 256, 1000]))
    else:
        kw["min_kv_chunk_size"] = int(rng.choice([16, 256]))
        kw["max_kv_chunk_size"] = int(rng.choice([1024, 4096]))
        if seed % 7 == 0:
            kw["target_num_items"] = int(rng.integers(1, 200))
    if seed % 6 == 0:
        kw["work_capacity"] = 4096
    return qo_indptr, kv, kw


@pytest.mark.parametrize("seed", range(40))
def test_native_plans_equal_numpy_and_jax(seed):
    qo_indptr, kv, kw = _batch(seed)
    nat = torch_plan.plan_attention(qo_indptr, kv, backend="native", **kw)
    _equal(nat, torch_plan.plan_attention(qo_indptr, kv, backend="numpy",
                                          **kw))
    _equal(nat, jax_plan._plan_attention_numpy(qo_indptr, kv, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(kv_chunk_size=100, page_size=16),
                                dict(work_capacity=32, tile_q=64)])
def test_empty_batch(kw):
    qo, kv = np.zeros(1, np.int64), np.zeros(0, np.int64)
    nat = torch_plan.plan_attention(qo, kv, backend="native", **kw)
    _equal(nat, torch_plan.plan_attention(qo, kv, backend="numpy", **kw))
    _equal(nat, jax_plan._plan_attention_numpy(qo, kv, **kw))
    assert nat.num_valid_items == 0 and (nat.request_indices == -1).all()


def test_native_planner_refuses_what_numpy_refuses():
    with pytest.raises(ValueError, match="capacity"):
        torch_plan.plan_attention(np.array([0, 8]), np.array([5000]),
                                  tile_q=8, kv_chunk_size=64,
                                  work_capacity=4, backend="numpy")
    with pytest.raises(ValueError, match="work_capacity"):
        torch_plan.plan_attention(np.array([0, 8]), np.array([5000]),
                                  tile_q=8, kv_chunk_size=64,
                                  work_capacity=4, backend="native")
    with pytest.raises(ValueError, match="qo_indptr"):
        native.native_plan_attention(np.array([0, 8, 16]), np.array([5]))


def test_planner_switch(monkeypatch):
    calls = []
    real_native = native.native_plan_attention
    monkeypatch.setattr(native, "native_plan_attention",
                        lambda *a, **k: calls.append("native")
                        or real_native(*a, **k))
    args = (np.array([0, 8]), np.array([40]))
    for env, want in (("auto", ["native"]), ("native", ["native"]),
                      ("numpy", []), ("NUMPY", [])):
        calls.clear()
        monkeypatch.setenv("FLASHINFER_TPU_PLANNER", env)
        torch_plan.plan_attention(*args, tile_q=8)
        assert calls == want, env
    monkeypatch.setenv("FLASHINFER_TPU_PLANNER", "cuda")
    with pytest.raises(ValueError, match="FLASHINFER_TPU_PLANNER"):
        torch_plan.plan_attention(*args, tile_q=8)
    # without a runtime: auto falls back to NumPy, native raises
    monkeypatch.setattr(native, "native_plan_available", lambda: False)
    monkeypatch.setenv("FLASHINFER_TPU_PLANNER", "auto")
    _equal(torch_plan.plan_attention(*args, tile_q=8),
           torch_plan.plan_attention(*args, tile_q=8, backend="numpy"))
    with pytest.raises(RuntimeError, match="native"):
        torch_plan.plan_attention(*args, tile_q=8, backend="native")


def _pool_ops(seed, n=120):
    """A seeded sequence of (op, args) on a pool of 40 pages of 8."""
    rng = np.random.default_rng(seed)
    live, lens, ops = [], {}, []
    for _ in range(n):
        r = rng.random()
        if r < 0.2 or not live:
            ops.append(("create",))
        elif r < 0.65:
            ops.append(("extend", int(rng.integers(len(live))),
                        int(rng.integers(1, 60))))
        elif r < 0.8:
            ops.append(("truncate", int(rng.integers(len(live))),
                        float(rng.random())))
        else:
            ops.append(("release", int(rng.integers(len(live)))))
        # track the live set the same way the pools will
        if ops[-1][0] == "create":
            live.append(len(ops))
        elif ops[-1][0] == "release":
            live.pop(ops[-1][1])
    return ops


def _drive(pool, ops):
    """Apply ``ops``; returns what each op returned and each export."""
    live, trace = [], []
    for op in ops:
        if op[0] == "create":
            live.append(pool.create())
            trace.append(live[-1])
        elif op[0] == "extend":
            s = live[op[1]]
            trace.append(pool.extend(s, pool.seq_len(s) + op[2]))
        elif op[0] == "truncate":
            s = live[op[1]]
            new = int(pool.seq_len(s) * op[2])
            pool.truncate(s, new)
            trace.append(new)
        else:
            pool.release(live.pop(op[1]))
            trace.append(None)
        trace.append(pool.free_pages)
        trace.append([a.tolist() for a in pool.batch_export(live)])
        trace.append([pool.pages(s).tolist() for s in live])
    return trace


@pytest.mark.parametrize("seed", range(3))
def test_native_pool_matches_python_and_jax(seed):
    ops = _pool_ops(seed)
    nat = native.PagePool(40, 8)
    assert type(nat) is native.PagePool  # the C++ pool, not the fallback
    want = _drive(PyPagePool(40, 8), ops)
    assert _drive(nat, ops) == want
    assert _drive(JaxPagePool(40, 8), ops) == want


def test_native_pool_refuses_bad_calls():
    pool = native.PagePool(4, 8)
    s = pool.create()
    assert pool.extend(s, 32) and not pool.extend(s, 33)  # OOM: unchanged
    assert pool.seq_len(s) == 32 and pool.free_pages == 0
    assert not pool.extend(s, 8)  # shrinking is truncate's
    with pytest.raises(ValueError):
        pool.truncate(s, 40)
    with pytest.raises(KeyError):
        pool.seq_len(s + 7)  # never created: the C table is not read
    pool.release(s)
    pool.release(s)  # a second release is a no-op, as in the Python pool
    with pytest.raises(KeyError):
        pool.pages(s)
    with pytest.raises(ValueError):
        native.PagePool(0, 8)


def test_pool_falls_back_without_a_runtime(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert type(native.PagePool(8, 8)) is PyPagePool
    assert not native.native_plan_available()


def test_runtime_registry_abi_and_handles(monkeypatch):
    lib = jit.get_native_runtime()
    assert lib is not None and jit.get_native_runtime() is lib
    st = jit.jit_registry.get_stats()["fi_native"]
    assert st["kind"] == "host" and str(jit.CACHE_DIR) in st["lib"]
    assert lib.fi_native_abi_version() == 4
    # the JAX package's library exports the same C symbols: each package
    # holds its own handle (ctypes' local mode) and plans through it
    jlib = jax_jit.get_native_runtime()
    assert jlib is not None and jlib._handle != lib._handle
    assert jlib._name != lib._name
    qo, kv = np.array([0, 16, 48]), np.array([100, 700])
    kw = dict(gqa_group=4, tile_q=16, kv_chunk_size=256, causal=True)
    from flashinfer_tpu.scheduler.native import native_plan_attention as jnp_
    _equal(native.native_plan_attention(qo, kv, **kw), jnp_(qo, kv, **kw))
    # a library of another ABI is refused, not used
    monkeypatch.setattr(jit_core, "_runtime", None)
    monkeypatch.setattr(jit_core, "_ABI_VERSION", 5)
    with pytest.raises(RuntimeError, match="ABI"):
        jit_core.get_native_runtime()


def test_host_spec_hashes_only_host_sources():
    """A CUDA header is not in the host library's key, and a host header
    is not in a kernel's."""
    spec = jit_core._NATIVE_RUNTIME_SPEC
    paths = [p.name for p in spec.source_paths()]
    assert paths == ["planner.cc", "page_pool.cc"]
    key = spec.content_hash()
    assert spec.lib_path.name == f"fi_native-{key}.so"
    assert spec.lib_path.exists()
    assert not any(p.suffix == ".cuh" for p in
                   jit_core.HOST_CSRC_DIR.iterdir())
    assert not list(jit_core.CSRC_DIR.glob("*.h"))


def test_engine_plans_natively_with_jaxs_tokens(monkeypatch):
    """The tiny Llama engine on the native pool and planner: every plan it
    builds equals the NumPy planner's field by field, and its greedy
    tokens equal JAX's engine's and the NumPy-planned engine's."""
    checked = []
    real = torch_batch.plan_attention

    def both(*a, **k):
        got = real(*a, backend="native", **k)
        _equal(got, real(*a, backend="numpy", **k))
        checked.append(got.num_valid_items)
        return got

    mc_jax = jax_llama.LlamaConfig.tiny()
    np_params = {k: np.asarray(v) for k, v in jax_llama.llama_init_weights(
        jax.random.key(0), mc_jax).items()}
    base = dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
                greedy=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, mc_jax.vocab_size, n).tolist()
               for n in (9, 4, 21)]
    jeng = jax_engine.LlamaServingEngine(
        jax_engine.EngineConfig(model=mc_jax, interpret=True, **base),
        params={k: jnp.asarray(v) for k, v in np_params.items()})
    reqs = [jeng.add_request(p, 5) for p in prompts]
    jeng.run_to_completion(max_steps=100)
    want = [r.output for r in reqs]

    params = params_from_numpy(np_params, device="cpu")
    outs = {}
    for planner in ("native", "numpy"):
        monkeypatch.setenv("FLASHINFER_TPU_PLANNER", planner)
        if planner == "native":
            monkeypatch.setattr(torch_batch, "plan_attention", both)
        else:
            monkeypatch.setattr(torch_batch, "plan_attention", real)
        eng = LlamaServingEngine(
            EngineConfig(model=LlamaConfig.tiny(), device="cpu", **base),
            params=params)
        assert type(eng.pool) is native.PagePool
        reqs = [eng.add_request(p, 5) for p in prompts]
        eng.run_to_completion(max_steps=100)
        outs[planner] = [r.output for r in reqs]
        assert eng.plan_seconds > 0
    assert len(checked) >= 5  # the prefill and every decode step
    assert outs["native"] == want
    assert outs["numpy"] == want
