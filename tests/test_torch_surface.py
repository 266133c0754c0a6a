"""The state / rope / page / activation surface and the top-level exports:
the port against the JAX package on the same inputs (numpy, seeded).

Tolerances: the merges to 1e-6 (f32 exp and log of the same values, summed
in other orders); rope to 1e-5 (f32 sin and cos of the same angles, up to
a few hundred radians, from two libraries); gelu_tanh_and_mul in f32 to
1e-6 relative plus 1e-5 absolute (on the gate's negative tail 1 + tanh(z)
cancels, so the libraries' f32 tanh, each within an ulp of -1, differ by
~1e-7 there, times gate and up values of up to ~10), in bf16 to one bf16
step (2^-8 relative); page offsets and views exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashinfer_tpu
import flashinfer_tpu_torch
from flashinfer_tpu import utils as jax_utils
from flashinfer_tpu.ops import activation as jax_act
from flashinfer_tpu.ops import page as jax_page
from flashinfer_tpu.ops import rope as jax_rope
from flashinfer_tpu.ops.attention import state as jax_state
from flashinfer_tpu_torch import utils
from flashinfer_tpu_torch.ops import activation, page, rope
from flashinfer_tpu_torch.ops.attention import state

# JAX's exports the port does not compute yet: none is left
PENDING_EXPORTS = ()
# JAX's subsystem namespaces the port does not have yet: none is left
PENDING_NAMESPACES = ()
# names of JAX's modules (and "Class.method" of their classes) that are TPU
# mechanics, with no counterpart: DevicePlan's pytree hooks exist for
# jax.jit, which the port's plan (a tensor blob) does not pass through
TPU_ONLY_NAMES = ("on_tpu", "default_interpret", "sublane_multiple",
                  "LAST_DIM_LANES", "rmsnorm_pallas", "fp8_k_permutation",
                  "bench_tpu_time", "bench_tpu_time_differential",
                  "DevicePlan.tree_flatten", "DevicePlan.tree_unflatten")


def _t(a):
    return torch.from_numpy(np.array(a))


def _states(rng, n, h=3, d=8, neg_inf_rows=(1,)):
    v = rng.standard_normal((n, h, d)).astype(np.float32)
    s = (rng.standard_normal((n, h)) * 3).astype(np.float32)
    for r in neg_inf_rows:
        s[r] = -np.inf
    return v, s


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------- state

@pytest.mark.parametrize("masked", [False, True])
def test_merge_state_in_place(masked):
    rng = np.random.default_rng(0)
    va, sa = _states(rng, 6, neg_inf_rows=(1, 4))
    vb, sb = _states(rng, 6, neg_inf_rows=(1, 2))
    mask = np.array([True, False, True, True, False, True])
    want_v, want_s = jax_state.merge_state_in_place(
        jnp.asarray(va), jnp.asarray(sa), jnp.asarray(vb), jnp.asarray(sb),
        jnp.asarray(mask) if masked else None)
    v, s = _t(va), _t(sa)
    got_v, got_s = state.merge_state_in_place(
        v, s, _t(vb), _t(sb), _t(mask) if masked else None)
    assert got_v is v and got_s is s  # written in place and returned
    _close(v, want_v)
    _close(s, want_s)
    if masked:  # rows under False keep their state
        assert torch.equal(v[~_t(mask)], _t(va)[~_t(mask)])
    assert torch.isneginf(s[1]).all()  # two empty states stay empty


def test_variable_length_merge_states():
    rng = np.random.default_rng(1)
    v, s = _states(rng, 9, neg_inf_rows=(0, 3, 4))
    # rows of 2, 0, 3 and 3 partials; row 1 has none
    indptr = np.array([0, 2, 2, 5, 8], np.int32)
    want = jax_state.variable_length_merge_states(
        jnp.asarray(v), jnp.asarray(s), jnp.asarray(indptr), 4)
    got = state.variable_length_merge_states(_t(v), _t(s), _t(indptr), 4)
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.isneginf(got[1][1]).all() and not got[0][1].any()


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_scatter_merge_states_drops_rows(dtype):
    """Negative rows are dropped, and the NaN they hold does not leak."""
    rng = np.random.default_rng(2)
    v, s = _states(rng, 10, neg_inf_rows=(5,))
    out_row = np.array([2, 0, -1, 2, 1, 0, -1, 2, 3, 1], np.int32)
    v[2], s[2] = np.nan, np.nan
    v[6], s[6] = np.inf, np.nan
    vj = jnp.asarray(v, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want_v, want_s = jax_state.scatter_merge_states(
        vj, jnp.asarray(s), jnp.asarray(out_row), 5)
    vt = (_t(v).to(torch.bfloat16) if dtype == "bf16" else _t(v))
    got_v, got_s = state.scatter_merge_states(vt, _t(s), _t(out_row), 5)
    assert got_v.dtype == vt.dtype and got_s.dtype == torch.float32
    assert torch.isfinite(got_v).all()
    tol = 2**-8 if dtype == "bf16" else 1e-6
    _close(got_v.float(), np.asarray(want_v, np.float32), tol)
    _close(got_s, want_s)
    assert torch.isneginf(got_s[4]).all()  # no partial reaches row 4


# -------------------------------------------------------------------- rope

def _qk(rng, nnz=7, hq=4, hkv=2, d=16):
    q = rng.standard_normal((nnz, hq, d)).astype(np.float32)
    k = rng.standard_normal((nnz, hkv, d)).astype(np.float32)
    return q, k


@pytest.mark.parametrize("rotary_dim,interleave", [(None, False),
                                                   (8, False), (None, True),
                                                   (8, True)])
def test_apply_rope_ragged(rotary_dim, interleave):
    rng = np.random.default_rng(3)
    q, k = _qk(rng)
    indptr = np.array([0, 3, 3, 7], np.int32)
    offsets = np.array([5, 0, 100], np.int32)
    kw = dict(rotary_dim=rotary_dim, interleave=interleave, rope_scale=2.0,
              rope_theta=1e4)
    want = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(indptr), jnp.asarray(offsets),
                               **kw)
    got = rope.apply_rope(_t(q), _t(k), _t(indptr), _t(offsets), **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    if rotary_dim:  # the dims past rotary_dim pass through
        assert torch.equal(got[0][..., rotary_dim:], _t(q)[..., rotary_dim:])


@pytest.mark.parametrize("rotary_dim,interleave", [(None, False),
                                                   (8, True)])
def test_apply_llama31_rope(rotary_dim, interleave):
    rng = np.random.default_rng(4)
    q, k = _qk(rng, d=32)
    pos = np.array([0, 1, 17, 300, 4095, 8191, 20000], np.int32)
    kw = dict(rotary_dim=rotary_dim, interleave=interleave)
    want = jax_rope.apply_llama31_rope_pos_ids(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), **kw)
    got = rope.apply_llama31_rope_pos_ids(_t(q), _t(k), _t(pos), **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    # the ragged form, with the scaling's other knobs
    indptr = np.array([0, 2, 7], np.int32)
    offsets = np.array([10, 3000], np.int32)
    kw.update(rope_scale=4.0, rope_theta=1e4, low_freq_factor=2.0,
              high_freq_factor=8.0, old_context_len=2048)
    want = jax_rope.apply_llama31_rope(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(indptr),
                                       jnp.asarray(offsets), **kw)
    got = rope.apply_llama31_rope(_t(q), _t(k), _t(indptr), _t(offsets),
                                  **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("rotary_dim", [16, 8])
@pytest.mark.parametrize("is_neox", [True, False])
def test_apply_rope_with_cos_sin_cache(rotary_dim, is_neox):
    rng = np.random.default_rng(5)
    q, k = _qk(rng)
    cache = np.asarray(jax_rope.rope_cos_sin_cache(64, rotary_dim,
                                                   rope_theta=1e4))
    got_cache = rope.rope_cos_sin_cache(64, rotary_dim, rope_theta=1e4,
                                        device="cpu")
    _close(got_cache, cache, 1e-5)
    pos = np.array([0, 63, 5, 5, 31, 2, 40], np.int32)
    want = jax_rope.apply_rope_with_cos_sin_cache(
        jnp.asarray(pos), jnp.asarray(q.reshape(7, -1)),
        jnp.asarray(k.reshape(7, -1)), 16, jnp.asarray(cache), is_neox)
    got = rope.apply_rope_with_cos_sin_cache(
        _t(pos), _t(q.reshape(7, -1)), _t(k.reshape(7, -1)), 16,
        _t(cache), is_neox)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5)


# -------------------------------------------------------------------- page

@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("stacked", [False, True])
def test_unpack_paged_kv_cache(layout, stacked):
    rng = np.random.default_rng(6)
    shape = (5, 2, 3, 8) if layout == "HND" else (5, 3, 2, 8)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    cache_np = np.stack([k, v], axis=1) if stacked else (k, v)
    want = jax_page.unpack_paged_kv_cache(
        jnp.asarray(cache_np) if stacked else tuple(map(jnp.asarray, (k, v))),
        layout)
    cache = _t(cache_np) if stacked else (_t(k), _t(v))
    got = page.unpack_paged_kv_cache(cache, layout)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (5, 3, 2, 8)
        assert np.array_equal(g.numpy(), np.asarray(w))
    # views: a write through them reaches the cache
    got[0][0, 0, 0, 0] = 123.0
    base = cache[:, 0] if stacked else cache[0]
    assert float(base.reshape(-1)[0]) == 123.0
    with pytest.raises(ValueError, match="pages, 2"):
        page.unpack_paged_kv_cache(torch.zeros(5, 3, 4, 8), layout)


@pytest.mark.parametrize("block_size,stride_block,stride_n",
                         [(4, 64, 16), (3, 48, 8), (1, 16, 16), (1, 32, 16)])
def test_block_sparse_indices_to_vector_sparse_offsets(block_size,
                                                       stride_block,
                                                       stride_n):
    rng = np.random.default_rng(7)
    blocks_per_row = np.array([2, 0, 3, 1])
    bs_indptr = np.concatenate([[0], np.cumsum(blocks_per_row)]).astype(
        np.int32)
    bs_indices = rng.permutation(20)[: bs_indptr[-1]].astype(np.int32)
    kv_lens = np.array([2 * block_size - 1, 0, 3 * block_size, 1], np.int32)
    vec_indptr = np.concatenate([[0], np.cumsum(blocks_per_row
                                                * block_size)]).astype(
                                                    np.int32)
    out = np.zeros(int(vec_indptr[-1]), np.int32)
    args_np = (bs_indices, bs_indptr, out, vec_indptr, kv_lens)
    want = jax_page.block_sparse_indices_to_vector_sparse_offsets(
        *map(jnp.asarray, args_np), stride_block, stride_n, block_size)
    got = page.block_sparse_indices_to_vector_sparse_offsets(
        *map(_t, args_np), stride_block, stride_n, block_size)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- activation

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_tanh_and_mul(dtype):
    x = np.random.default_rng(8).standard_normal((5, 2, 64)) * 3
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_act.gelu_tanh_and_mul(jnp.asarray(x, jdt)),
                      np.float32)
    got = activation.gelu_tanh_and_mul(_t(x).to(tdt), enable_pdl=True)
    assert got.dtype == tdt and tuple(got.shape) == (5, 2, 32)
    rtol, atol = (1e-6, 1e-5) if dtype == "f32" else (2**-8, 2**-8)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


# ------------------------------------------------------ enums and exports

def test_enums_match_jax():
    for name in ("MaskMode", "PosEncodingMode", "TensorLayout"):
        ours, theirs = getattr(utils, name), getattr(jax_utils, name)
        assert {m.name: int(m) for m in ours} == {m.name: int(m)
                                                  for m in theirs}
        assert getattr(flashinfer_tpu_torch, name) is ours


def test_exports_are_jax_exports_but_the_pending():
    assert PENDING_EXPORTS == ()
    assert sorted(flashinfer_tpu_torch.__all__) == sorted(
        flashinfer_tpu.__all__)
    assert flashinfer_tpu_torch.__version__ == flashinfer_tpu.__version__
    assert len(flashinfer_tpu_torch.__all__) == len(
        set(flashinfer_tpu_torch.__all__))
    for name in flashinfer_tpu_torch.__all__:
        assert getattr(flashinfer_tpu_torch, name) is not None, name


def test_namespaces_are_jaxs_but_the_pending():
    """Every module JAX's package exposes (the op modules and the subsystem
    namespaces: aot, autotuner, jit, logits_processor, models, profiler,
    scheduler, serving, testing) is a module of the port of the same name,
    but the pending ones."""
    import types

    def modules(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and isinstance(getattr(pkg, n), types.ModuleType)}

    jax_mods, ours = modules(flashinfer_tpu), modules(flashinfer_tpu_torch)
    assert PENDING_NAMESPACES == ()
    assert jax_mods - ours == set(PENDING_NAMESPACES)
    for name in jax_mods - set(PENDING_NAMESPACES):
        mod = getattr(flashinfer_tpu_torch, name)
        assert mod.__name__.startswith("flashinfer_tpu_torch."), name
        assert mod.__name__.rsplit(".", 1)[-1] == name


def _jax_modules_with_all():
    import importlib
    import pkgutil

    for info in pkgutil.walk_packages(flashinfer_tpu.__path__,
                                      "flashinfer_tpu."):
        mod = importlib.import_module(info.name)
        if hasattr(mod, "__all__"):
            yield info.name, mod


def test_every_jax_module_all_is_in_the_port():
    """Each module of JAX's package that declares ``__all__`` has a
    counterpart of the same path in the port holding every name of it,
    and every public method of its classes, but the TPU-only ones."""
    import importlib
    import inspect

    missing, tpu_only = {}, set()
    for name, mod in _jax_modules_with_all():
        ours = importlib.import_module(
            "flashinfer_tpu_torch." + name[len("flashinfer_tpu."):])
        lack = [n for n in mod.__all__ if not hasattr(ours, n)]
        for n in mod.__all__:
            cls, our_cls = getattr(mod, n), getattr(ours, n, None)
            if inspect.isclass(cls) and our_cls is not None:
                lack += [f"{n}.{m}" for m in dir(cls)
                         if not m.startswith("_")
                         and callable(getattr(cls, m))
                         and not hasattr(our_cls, m)]
        tpu_only.update(n for n in lack if n in TPU_ONLY_NAMES)
        lack = [n for n in lack if n not in TPU_ONLY_NAMES]
        if lack:
            missing[name] = lack
    assert missing == {}
    assert tpu_only == set(TPU_ONLY_NAMES)  # the list holds no stale name


def test_distributed_modules_import_no_jax():
    """The parallel layer and the distributed engine import torch alone:
    no ``jax`` or ``flashinfer_tpu`` module is loaded (a fresh
    interpreter)."""
    import subprocess
    import sys

    code = ("import sys, flashinfer_tpu_torch.parallel, "
            "flashinfer_tpu_torch.serving.distributed; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flashinfer_tpu')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.stdout.strip() == "[]"
