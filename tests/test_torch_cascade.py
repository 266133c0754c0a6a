"""Cascade attention: the port's ``MultiLevelCascadeAttentionWrapper``
(plain paged attention on the CPU, levels folded by ``merge_state``)
against the JAX package's (its dense oracle a level, as
tests/test_cascade_mla.py runs it), and against the port's flat
``BatchAttention`` over the concatenated page tables, at two and three
levels, f32 and bf16, NHD and HND, pages of 8 (the port's smallest; JAX's
test uses 4).

Tolerances: f32 o and lse to 2e-5 (softmax sums in other orders). bf16 o
to 2^-6 |ref| + 2^-8 (each side rounds o to bf16 once a level, and the
port's plain version rounds P to bf16 where JAX's oracle keeps it in f32:
the attention tolerance of chip_smoke.py), lse to 1e-3 (f32 sums of bf16
scores in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention.cascade import (
    MultiLevelCascadeAttentionWrapper as JaxCascade,
)
from flashinfer_tpu_torch.ops.attention.batch import BatchAttention
from flashinfer_tpu_torch.ops.attention.cascade import (
    MultiLevelCascadeAttentionWrapper,
)
from flashinfer_tpu_torch.utils import tensor_from_numpy

PS = 8
HQ, HKV, D = 4, 2, 32
CHUNK = 16  # several KV chunks a level: split-KV partials merge too
QO = [1, 3, 2, 4]  # query tokens a request: decode and append rows mixed
# shared KV tokens a level above the last (page-aligned) and the groups
# that share them; the last level gives each request its own suffix
LEVELS = {2: ((24, [4]),),
          3: ((16, [4]), (8, [2, 2]))}
SUFFIX = [9, 5, 16, 12]

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tables(rng, num_levels):
    """Per-level (qo_indptr, kv_indptr, kv_indices, last) and the flat
    table (kv_indptr, kv_indices, last) naming each request's pages of
    every level in order, from one permutation of the pool."""
    nreq = len(QO)
    qo_req = np.concatenate([[0], np.cumsum(QO)])
    blocks = []  # (groups, pages per group) of the upper levels
    num_pages = 0
    for tokens, groups in LEVELS[num_levels]:
        blocks.append((groups, tokens // PS))
        num_pages += len(groups) * tokens // PS
    suf_pages = -(-np.asarray(SUFFIX) // PS)
    num_pages += int(suf_pages.sum())
    perm = rng.permutation(num_pages)
    pos, levels = 0, []
    req_pages = [[] for _ in range(nreq)]
    for groups, npg in blocks:
        qo_indptr, kv_indptr, idx, req = [0], [0], [], 0
        for size in groups:
            pages = perm[pos:pos + npg]
            pos += npg
            idx.extend(pages)
            kv_indptr.append(len(idx))
            qo_indptr.append(qo_req[req + size])
            for r in range(req, req + size):
                req_pages[r].extend(pages)
            req += size
        levels.append((np.asarray(qo_indptr), np.asarray(kv_indptr),
                       np.asarray(idx), np.full(len(groups), PS)))
    suf_indptr = np.concatenate([[0], np.cumsum(suf_pages)])
    suf_idx = perm[pos:]
    last = np.asarray(SUFFIX) - (suf_pages - 1) * PS
    levels.append((qo_req, suf_indptr, suf_idx, last))
    for r in range(nreq):
        req_pages[r].extend(suf_idx[suf_indptr[r]:suf_indptr[r + 1]])
    flat_indptr = np.concatenate([[0], np.cumsum([len(p)
                                                  for p in req_pages])])
    flat = (flat_indptr, np.concatenate(req_pages), last)
    return num_pages, levels, flat


def _inputs(num_levels, dtype, layout):
    rng = np.random.default_rng(num_levels)
    num_pages, levels, flat = _tables(rng, num_levels)
    shape = ((num_pages, HKV, PS, D) if layout == "HND"
             else (num_pages, PS, HKV, D))
    jdt = _DTYPES[dtype][0]
    q = np.asarray(jnp.asarray(rng.standard_normal((sum(QO), HQ, D)), jdt))
    k = np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
    v = np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
    return levels, flat, q, k, v


def _port_cascade(num_levels, layout, levels, q, k, v, **run_kw):
    w = MultiLevelCascadeAttentionWrapper(num_levels, kv_layout=layout,
                                          device="cpu")
    w.plan(*zip(*levels), HQ, HKV, D, PS, causal=True, kv_chunk_size=CHUNK)
    t = [tensor_from_numpy(a, "cpu") for a in (q, k, v)]
    return w.run(t[0], (t[1], t[2]), **run_kw)


def _close(dtype, got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "f32" or what == "lse":
        tol = 2e-5 if dtype == "f32" else 1e-3
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert np.all(np.abs(got - want) <= 2**-6 * np.abs(want) + 2**-8)


@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("num_levels", [2, 3])
def test_cascade_matches_jax(num_levels, dtype, layout):
    levels, _, q, k, v = _inputs(num_levels, dtype, layout)
    jw = JaxCascade(num_levels, kv_layout=layout, backend="reference")
    jw.plan(*zip(*levels), HQ, HKV, D, PS, causal=True)
    want_o, want_lse = jw.run(jnp.asarray(q), (jnp.asarray(k),
                                               jnp.asarray(v)),
                              return_lse=True)
    got_o, got_lse = _port_cascade(num_levels, layout, levels, q, k, v,
                                   return_lse=True)
    assert got_o.dtype == _DTYPES[dtype][1] and got_lse.dtype == torch.float32
    _close(dtype, got_o, want_o, "o")
    _close(dtype, got_lse, want_lse, "lse")
    # without return_lse: o alone, the same values
    o = _port_cascade(num_levels, layout, levels, q, k, v)
    assert torch.equal(o, got_o)


@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("num_levels", [2, 3])
def test_cascade_matches_flat_attention(num_levels, dtype, layout):
    """Cascade against one flat plan over every request's pages (the
    shared ones named in each request), causal at the end of the keys."""
    levels, flat, q, k, v = _inputs(num_levels, dtype, layout)
    got_o, got_lse = _port_cascade(num_levels, layout, levels, q, k, v,
                                   return_lse=True)
    fw = BatchAttention(kv_layout=layout, device="cpu").plan(
        levels[-1][0], *flat, HQ, HKV, D, PS, causal=True,
        kv_chunk_size=CHUNK)
    t = [tensor_from_numpy(a, "cpu") for a in (q, k, v)]
    want_o, want_lse = fw.run(t[0], (t[1], t[2]), return_lse=True)
    _close(dtype, got_o, want_o.float().numpy(), "o")
    _close(dtype, got_lse, want_lse.numpy(), "lse")


def test_cascade_plan_checks_levels():
    w = MultiLevelCascadeAttentionWrapper(2, device="cpu")
    with pytest.raises(ValueError, match="index sets"):
        w.plan([np.array([0, 1])], [np.array([0, 1])], [np.array([0])],
               [np.array([PS])], HQ, HKV, D, PS, kv_chunk_size=CHUNK)
    assert len(w.levels) == 2
