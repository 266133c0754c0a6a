"""POD attention (one chunked prefill beside a decode batch): both modes of
the port's ``PODWithPagedKVCacheWrapper`` on the CPU (the flash and paged
kernels' plain versions) against the JAX package's wrapper with its Pallas
kernels in interpret mode, on the same numpy inputs. Page 16: the port
refuses pages under 8.

Tolerance: f32 o and lse within 2e-5 (sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention.pod import (
    PODWithPagedKVCacheWrapper as JaxPOD,
)
from flashinfer_tpu_torch.ops.attention.pod import PODWithPagedKVCacheWrapper

HQ, HKV, D, PS = 4, 2, 32, 16
TOL = 2e-5


def _inputs(rng, layout):
    qo_len, kv_len = 12, 40  # the chunk sits at the tail of its prompt
    kv_lens = np.asarray([20, 37, 5])
    pages = -(-kv_lens // PS)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    num_pages = 16
    indices = rng.permutation(num_pages)[: indptr[-1]]
    last = kv_lens - (pages - 1) * PS
    free = [p for p in range(num_pages) if p not in set(indices.tolist())]
    shape = ((num_pages, HKV, PS, D) if layout == "HND"
             else (num_pages, PS, HKV, D))
    arrs = dict(
        q_p=rng.standard_normal((qo_len, HQ, D)),
        k_p=rng.standard_normal((kv_len, HKV, D)),
        v_p=rng.standard_normal((kv_len, HKV, D)),
        q_d=rng.standard_normal((len(kv_lens), HQ, D)),
        k_c=rng.standard_normal(shape), v_c=rng.standard_normal(shape))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    plan = (indptr, indices, last, HQ, HKV, D, PS)
    kw = dict(kv_len_arr=kv_lens, kv_chunk_size=16)
    combined = dict(prefill_qo_len=qo_len, prefill_kv_len=kv_len,
                    prefill_page_indices=free)
    return arrs, plan, kw, combined


@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("mode", ["two_launch", "combined"])
def test_pod_matches_jax(mode, layout):
    rng = np.random.default_rng([mode == "combined", layout == "HND"])
    a, plan, kw, combined = _inputs(rng, layout)
    if mode == "combined":
        kw = dict(kw, **combined)
    jw = JaxPOD(kv_layout=layout, backend="pallas").plan(*plan, **kw)
    tw = PODWithPagedKVCacheWrapper(kv_layout=layout, device="cpu").plan(
        *plan, **kw)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    want = jw.run(j["q_p"], j["k_p"], j["v_p"], j["q_d"],
                  (j["k_c"], j["v_c"]), return_lse=True)
    cache = (t["k_c"], t["v_c"])
    got = tw.run(t["q_p"], t["k_p"], t["v_p"], t["q_d"], cache,
                 return_lse=True)
    if mode == "combined":
        (wo, wcache, wlse), (go, gcache, glse) = want, got
        assert gcache is cache  # appended in place
        for g, w in zip(gcache, wcache):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        (wo, wlse), (go, glse) = want, got
    for g, w in zip(go + glse, wo + wlse):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_pod_modes_agree():
    """Combined mode (one paged launch) equals two-launch mode (flash
    kernel + paged kernel) on the port alone."""
    rng = np.random.default_rng(7)
    a, plan, kw, combined = _inputs(rng, "HND")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    two = PODWithPagedKVCacheWrapper(device="cpu").plan(*plan, **kw)
    one = PODWithPagedKVCacheWrapper(device="cpu").plan(*plan, **kw,
                                                        **combined)
    p2, d2 = two.run(t["q_p"], t["k_p"], t["v_p"], t["q_d"],
                     (t["k_c"], t["v_c"]))
    (p1, d1), _ = one.run(t["q_p"], t["k_p"], t["v_p"], t["q_d"],
                          (t["k_c"].clone(), t["v_c"].clone()))
    torch.testing.assert_close(p1, p2, atol=TOL, rtol=TOL)
    torch.testing.assert_close(d1, d2, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="prefill"):
        one.run(t["q_p"][:3], t["k_p"], t["v_p"], t["q_d"],
                (t["k_c"], t["v_c"]))
