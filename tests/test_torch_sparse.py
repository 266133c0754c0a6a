"""Block-sparse (BSR) and variable-block-sparse attention: the port's
wrappers (the paged kernel's plain version on the CPU, and the "reference"
backend) against the JAX package's on its Pallas kernel in interpret mode,
and against dense attention under the blocks' mask, on the same seeded
numpy inputs.

Tolerance: f32 o to 2e-5 (sums in other orders). The plan is JAX's
(blocks of 8 and 12 columns, read in place; variable blocks, repacked from
pages of one token), and the blob equals JAX's bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import sparse as jax_sparse
from flashinfer_tpu_torch.ops.attention import sparse
from flashinfer_tpu_torch.ops.attention.reference import attention_reference

HQ, HKV, D = 4, 2, 32
TOL = 2e-5


def _qkv(rng, m, n):
    return (rng.standard_normal((m, HQ, D)).astype(np.float32),
            rng.standard_normal((n, HKV, D)).astype(np.float32),
            rng.standard_normal((n, HKV, D)).astype(np.float32))


def _dense(q, k, v, mask):
    """Dense attention under ``mask`` [M, N] (the oracle)."""
    return attention_reference(*map(torch.from_numpy, (q, k, v)),
                               custom_mask=torch.from_numpy(mask))[0]


def _both(jw, tws, q, k, v, same_plan):
    want = np.asarray(jw.run(*map(jnp.asarray, (q, k, v)), interpret=True))
    outs = [w.run(*map(torch.from_numpy, (q, k, v))) for w in tws]
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if same_plan:
        assert np.array_equal(np.asarray(jw.device_plan.blob),
                              tws[0].device_plan.blob.numpy())
    return outs[0]


@pytest.mark.parametrize("C", [8, 12])
def test_block_sparse(C):
    rng = np.random.default_rng(C)
    R, mb, nb = 4, 4, 4
    M, N = R * mb, C * nb
    indptr = np.asarray([0, 2, 3, 5, 6])
    indices = np.asarray([0, 2, 1, 0, 3, 2])
    q, k, v = _qkv(rng, M, N)
    plan = (indptr, indices, M, N, R, C, HQ, HKV, D)
    jw = jax_sparse.BlockSparseAttentionWrapper(backend="pallas", tile_q=8)
    jw.plan(*plan, kv_chunk_size=16)
    tws = [sparse.BlockSparseAttentionWrapper(backend=b, tile_q=8,
                                              device="cpu")
           for b in ("auto", "reference")]
    for w in tws:
        w.plan(*plan, kv_chunk_size=16)
    assert tws[0].device_plan.meta.page_size == C
    got = _both(jw, tws, q, k, v, same_plan=True)
    mask = np.zeros((M, N), bool)
    for rb in range(mb):
        for cb in indices[indptr[rb]:indptr[rb + 1]]:
            mask[rb * R:(rb + 1) * R, cb * C:(cb + 1) * C] = True
    torch.testing.assert_close(got, _dense(q, k, v, mask), atol=TOL,
                               rtol=TOL)


def test_variable_block_sparse():
    rng = np.random.default_rng(1)
    rows, cols = np.asarray([3, 5, 4]), np.asarray([4, 2, 6, 9])
    mask_map = np.asarray([[1, 0, 1, 0], [0, 1, 1, 1], [1, 1, 0, 0]], bool)
    q, k, v = _qkv(rng, int(rows.sum()), int(cols.sum()))
    plan = (mask_map, rows, cols, HQ, HKV, D)
    jw = jax_sparse.VariableBlockSparseAttentionWrapper(backend="pallas")
    jw.plan(*plan)
    tws = [sparse.VariableBlockSparseAttentionWrapper(backend=b,
                                                      device="cpu")
           for b in ("auto", "reference")]
    for w in tws:
        w.plan(*plan)
    got = _both(jw, tws, q, k, v, same_plan=True)
    r0, c0 = np.cumsum(rows) - rows, np.cumsum(cols) - cols
    mask = np.zeros((int(rows.sum()), int(cols.sum())), bool)
    for rb, cb in zip(*np.nonzero(mask_map)):
        mask[r0[rb]:r0[rb] + rows[rb], c0[cb]:c0[cb] + cols[cb]] = True
    torch.testing.assert_close(got, _dense(q, k, v, mask), atol=TOL,
                               rtol=TOL)
