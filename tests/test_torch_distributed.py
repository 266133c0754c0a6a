"""The dp x tp serving engine (``flashinfer_tpu_torch.serving.distributed``)
on gloo: its greedy tokens against JAX's ``DistributedServingEngine`` and
the port's ``LlamaServingEngine`` on the same numpy weights.

The port's engines run in worker processes, one a rank (this file run as a
script, ``python tests/test_torch_distributed.py GROUP DIR RANK WORLD``,
which imports no JAX; the group comes up through ``bootstrap_distributed``
on a FileStore): world 4 serves (dp, tp) = (2, 2) with model-dtype, e4m3
and int8 KV, a sampled run, and a config JAX's engine takes but does not
apply (HND, a decode window of 3, pages of 12 tokens); world 2 serves
(1, 2) and (2, 1) and a late admission. JAX's engine and the single-card ``LlamaServingEngine`` (held to
JAX by ``tests/test_torch_engine.py``) run here. Greedy tokens must be
equal; every rank must emit the same tokens."""

import os
import sys
import warnings

import numpy as np
import pytest

from test_torch_parallel import spawn

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [3, 1]]
N_NEW = [6, 5, 4, 6]
KV = ("model", "fp8_e4m3", "int8")
# fields of the single-card engine that the dp x tp engines serve without
# (model-dtype weights on their own NHD caches, one token a step), and a
# page size that is not a multiple of 8
UNAPPLIED = dict(kv_layout="HND", decode_window=3, page_size=12)
# tiny f32 Llama and engine (tests/test_distributed_serving.py's _tiny_cfg)
MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_qo_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)
ENGINE = dict(max_batch=2, num_pages=64, page_size=8, max_seq_len=128,
              greedy=True, kv_scale=0.05)


def _port_config(torch, **kw):
    from flashinfer_tpu_torch.models.llama import LlamaConfig
    from flashinfer_tpu_torch.serving.engine import EngineConfig

    args = dict(ENGINE, **kw)
    return EngineConfig(model=LlamaConfig(**MODEL, dtype=torch.float32),
                        device="cpu", **args)


def _serve(eng, prompts=PROMPTS, n_new=N_NEW, **kw):
    reqs = [eng.add_request(p, n, **kw) for p, n in zip(prompts, n_new)]
    eng.run_to_completion(max_steps=200)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _tokens_array(outs):
    """Ragged token lists as one padded int array (-1 after each end)."""
    width = max(len(o) for o in outs)
    return np.asarray([o + [-1] * (width - len(o)) for o in outs])


def _port_world(d, out, rank, world):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    params = {k: v for k, v in d.items()}

    def mesh(shape):
        return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("dp", "tp"))

    if world == 4:
        m = mesh((2, 2))
        for kv in KV:
            eng = DistributedServingEngine(_port_config(torch, kv_dtype=kv),
                                           m, params=params)
            out[f"dp2tp2_{kv}"] = _tokens_array(_serve(eng))
        eng = DistributedServingEngine(
            _port_config(torch, greedy=False, top_k=8, top_p=0.9), m,
            params=params, seed=3)
        out["sampled"] = _tokens_array(_serve(eng))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = DistributedServingEngine(
                _port_config(torch, **UNAPPLIED), m, params=params)
        out["unapplied_warnings"] = np.asarray(
            [str(w.message) for w in caught
             if issubclass(w.category, UserWarning)])
        out["unapplied"] = _tokens_array(_serve(eng))
        return
    for shape in ((1, 2), (2, 1)):
        eng = DistributedServingEngine(_port_config(torch), mesh(shape),
                                       params=params)
        out[f"dp{shape[0]}tp{shape[1]}_model"] = _tokens_array(_serve(eng))
    # one slot: the second request waits for the first to finish
    eng = DistributedServingEngine(_port_config(torch, max_batch=1),
                                   mesh((1, 2)), params=params)
    out["late"] = _tokens_array(_serve(eng, [[1, 2, 3], [4, 5]], [3, 3],
                                       replica=0))


def _worker(group, outdir, rank, world):
    import torch
    import torch.distributed as dist

    from flashinfer_tpu_torch.serving.distributed import bootstrap_distributed

    torch.set_num_threads(1)
    got = bootstrap_distributed(f"file://{outdir}/store", world, rank)
    assert got == rank and dist.get_backend() == "gloo"
    data = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    _port_world(data, out, rank, world)
    np.savez(os.path.join(outdir, f"out_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _jax_params():
    import jax
    import jax.numpy as jnp

    from flashinfer_tpu.models.llama import LlamaConfig, llama_init_weights

    params = llama_init_weights(jax.random.key(0),
                                LlamaConfig(**MODEL, dtype=jnp.float32))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params():
    return _jax_params()


def _spawn(params, tmp_path_factory, n):
    return spawn(os.path.abspath(__file__), "engines",
                 tmp_path_factory.mktemp(f"world{n}"), n, params)


@pytest.fixture(scope="module")
def world4(params, tmp_path_factory):
    return _spawn(params, tmp_path_factory, 4)


@pytest.fixture(scope="module")
def world2(params, tmp_path_factory):
    return _spawn(params, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def single_card_tokens(params):
    """The port's LlamaServingEngine on the same weights, a KV dtype
    each."""
    import torch

    from flashinfer_tpu_torch.models.llama import params_from_numpy
    from flashinfer_tpu_torch.serving.engine import LlamaServingEngine

    out = {}
    for kv in KV:
        eng = LlamaServingEngine(_port_config(torch, kv_dtype=kv),
                                 params=params_from_numpy(params, "cpu"))
        out[kv] = _tokens_array(_serve(eng))
    return out


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


def test_dp2_tp2_matches_jax_distributed_engine(world4, params):
    """Greedy tokens at (dp, tp) = (2, 2) equal JAX's
    ``DistributedServingEngine`` on the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flashinfer_tpu.models.llama import LlamaConfig
    from flashinfer_tpu.serving import EngineConfig
    from flashinfer_tpu.serving.distributed import DistributedServingEngine

    cfg = EngineConfig(model=LlamaConfig(**MODEL, dtype=jnp.float32),
                       interpret=True, **ENGINE)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    eng = DistributedServingEngine(
        cfg, mesh, params={k: jnp.asarray(v) for k, v in params.items()})
    want = _tokens_array(_serve(eng))
    np.testing.assert_array_equal(
        _same_on_every_rank(world4, "dp2tp2_model"), want)


def test_dp2_tp2_serves_what_jax_serves_of_a_single_card_config(world4,
                                                                params):
    """``kv_layout="HND"`` and ``decode_window=3`` (the single-card
    engine's) at pages of 12 tokens: JAX's ``DistributedServingEngine``
    serves them as model-dtype weights on NHD caches, one token a step, and
    so does the port's, with the same greedy tokens on every rank and one
    ``UserWarning`` naming the fields it does not apply."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flashinfer_tpu.models.llama import LlamaConfig
    from flashinfer_tpu.serving import EngineConfig
    from flashinfer_tpu.serving.distributed import DistributedServingEngine

    cfg = EngineConfig(model=LlamaConfig(**MODEL, dtype=jnp.float32),
                       interpret=True, **dict(ENGINE, **UNAPPLIED))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    eng = DistributedServingEngine(
        cfg, mesh, params={k: jnp.asarray(v) for k, v in params.items()})
    want = _tokens_array(_serve(eng))
    np.testing.assert_array_equal(
        _same_on_every_rank(world4, "unapplied"), want)
    for out in world4:
        (msg,) = out["unapplied_warnings"]
        assert "decode_window, kv_layout" in str(msg)


@pytest.mark.parametrize("kv", KV)
def test_dp2_tp2_matches_single_card_engine(world4, single_card_tokens, kv):
    """(2, 2) with each KV dtype: the single-card engine's greedy tokens,
    on every rank."""
    np.testing.assert_array_equal(_same_on_every_rank(world4, f"dp2tp2_{kv}"),
                                  single_card_tokens[kv])


@pytest.mark.parametrize("shape", ["dp1tp2", "dp2tp1"])
def test_world2_matches_single_card_engine(world2, single_card_tokens,
                                           shape):
    np.testing.assert_array_equal(
        _same_on_every_rank(world2, f"{shape}_model"),
        single_card_tokens["model"])


def test_sampled_tokens_agree_on_every_rank(world4):
    """Sampled decoding at (2, 2): the full vocabulary rows gathered over
    tp and the sampler run on each; every rank emits the same tokens, each
    request its budget."""
    toks = _same_on_every_rank(world4, "sampled")
    assert [(row >= 0).sum() for row in toks] == N_NEW
    assert ((toks < MODEL["vocab_size"])).all()


def test_late_admission_at_dp1_tp2(world2):
    """One slot: a request queued behind another is admitted once the
    slot frees, and both finish their budgets (JAX's continuous-batching
    test)."""
    toks = _same_on_every_rank(world2, "late")
    assert [(row >= 0).sum() for row in toks] == [3, 3]


def test_bootstrap_without_arguments_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from flashinfer_tpu_torch.serving.distributed import bootstrap_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert bootstrap_distributed() == 0
    assert not dist.is_initialized()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
