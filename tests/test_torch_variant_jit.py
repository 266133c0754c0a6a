"""The variant JIT (``flashinfer_tpu_torch/jit/variant.py``) on the CPU:
callers' attention variants written as plain torch hooks, traced into
scalar functions of a generated header.

For each variant: the traced graph, evaluated on CPU tensors, equals the
hook bit for bit (alone, and inside the plain versions in place of the
hooks); the header, compiled as host code with the system C++ compiler and
loaded by ctypes, equals the hook to 1e-6 relative; equal hooks give equal
build keys and a changed closure constant another; a construct outside the
subset raises ``NotImplementedError`` naming its op on a CUDA-marked call,
before any build; and the variant through ``single_prefill_with_kv_cache``
and the batch prefill / decode wrappers equals JAX's with the same hooks
written in ``jnp`` (JAX's flash and paged kernels in interpret mode), f32
o and lse to 2e-5. The kernels' builds themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s variants phase).

Two quirks of the reference are pinned here: JAX's flash kernel drops
``output_transform`` under softmax, which its oracle applies (the port
applies it, as the oracle and FlashInfer do), and JAX's paged kernel
applies none (nor does the port's). And the sigmoid at bias -1 over
hundreds of keys, where the card's bf16 limit broke: rounding the weights
to bf16, as JAX's kernel does, is itself far from float64 there."""

import ctypes
import math
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu.ops.attention import batch as jax_batch
from flashinfer_tpu.ops.attention import reference as jax_reference
from flashinfer_tpu.ops.attention import variants as jax_variants
from flashinfer_tpu.ops.attention.kernels.flash import (
    flash_attention_dense as jax_flash,
)
from flashinfer_tpu_torch import jit
from flashinfer_tpu_torch.jit import variant as vjit
from flashinfer_tpu_torch.ops.attention import batch as torch_batch
from flashinfer_tpu_torch.ops.attention import variants as torch_variants
from flashinfer_tpu_torch.ops.attention.kernels import flash, paged
from flashinfer_tpu_torch.ops.attention.kernels.flash import (
    flash_attention_plain,
)
from flashinfer_tpu_torch.jit.env import cxx
from flashinfer_tpu_torch.ops.attention.single import (
    single_prefill_with_kv_cache,
)

TOL = 2e-5
HQ, HKV, D = 4, 2, 32
QO, KV = 24, 40
NAMES = ["alibi", "doc_mask", "q_out", "sigmoid", "soft_cap"]


def _hooks(name, xp):
    """The hooks of one variant, in torch (``xp`` torch) or jnp: (kwargs
    of AttentionVariant)."""
    def f32(x):
        return x.float() if xp is torch else x.astype(jnp.float32)

    def exp(x):
        return torch.exp(x) if xp is torch else jnp.exp(x)

    def tanh(x):
        return torch.tanh(x) if xp is torch else jnp.tanh(x)

    if name == "alibi":
        return dict(logits_transform=lambda p, s, qp, kp, h: (
            s + p["alibi_slopes"][h] * f32(kp - qp)))
    if name == "doc_mask":
        return dict(logits_mask=lambda p, qp, kp, h: (
            p["doc"][qp] == p["doc"][kp]))
    if name == "q_out":
        return dict(query_transform=lambda p, x: x * p["q_scale"],
                    output_transform=lambda p, o: o * 1.5 + p["o_bias"])
    if name == "sigmoid":
        return dict(use_softmax=False, logits_transform=lambda p, s, qp, kp,
                    h: 1.0 / (1.0 + exp(-(s * 0.5 - 1.0))))
    return dict(logits_transform=lambda p, s, qp, kp, h: (
        2.0 * tanh(s / 2.0)))


def _params(name, hq=HQ, n=KV + 64):
    """The variant's params as numpy values (None for none); the document
    table covers a tile past the keys and is not hq long (JAX's flash
    kernel would block such a leaf to the head)."""
    if name == "alibi":
        return {"alibi_slopes": (0.5 ** np.arange(1, hq + 1)).astype(
            np.float32)}
    if name == "doc_mask":
        return {"doc": (np.arange(n) // 7).astype(np.int32)}
    if name == "q_out":
        return {"q_scale": np.asarray(0.75, np.float32), "o_bias": 0.25}
    return None


def _conv(params, fn):
    if params is None:
        return None
    return {k: (fn(v) if isinstance(v, np.ndarray) else v)
            for k, v in params.items()}


def _variant(name, mod, xp):
    return mod.AttentionVariant(name=name, **_hooks(name, xp))


def _torch_variant(name, hq=HQ, n=KV + 64):
    return (_variant(name, torch_variants, torch),
            _conv(_params(name, hq, n), torch.from_numpy))


def _jax_variant(name, hq=HQ, n=KV + 64):
    return (_variant(name, jax_variants, jnp),
            _conv(_params(name, hq, n), jnp.asarray))


def _grid():
    """The plain flash version's hook arguments: logits [g, q, k] over
    query positions [q, 1], key positions [1, k] and heads [g, 1, 1]."""
    gen = torch.Generator().manual_seed(5)
    s = torch.randn(HQ, QO, KV, generator=gen) * 6
    q_pos = torch.arange(QO)[:, None] + (KV - QO)
    kv_pos = torch.arange(KV)[None, :]
    head = torch.arange(HQ)[:, None, None]
    x = torch.randn(QO, HQ, D, generator=gen) * 3
    return s, q_pos, kv_pos, head, x


def _hook_outputs(variant, params, role):
    s, q_pos, kv_pos, head, x = _grid()
    fn = getattr(variant, role)
    if role == "logits_transform":
        return fn(params, s, q_pos, kv_pos, head), dict(
            s=s, q_pos=q_pos, kv_pos=kv_pos, head=head)
    if role == "logits_mask":
        return fn(params, q_pos, kv_pos, head), dict(
            q_pos=q_pos, kv_pos=kv_pos, head=head)
    return fn(params, x), dict(x=x)


@pytest.mark.parametrize("name", NAMES)
def test_traced_graph_equals_the_hook(name):
    variant, params = _torch_variant(name)
    c = vjit.compile_variant(variant, params, "flash", HQ)
    assert c.graphs and c.softmax == variant.use_softmax
    for role, graph in c.graphs.items():
        want, args = _hook_outputs(variant, params, role)
        got = vjit.evaluate(graph, args, params, list(c.leaves))
        assert got.dtype == want.dtype and torch.equal(got, want), role

    # the graphs in place of the hooks: the plain version gives the same
    # bits (the positions and heads it passes, the roundings after)
    def graph_hook(role, names):
        g = c.graphs[role]
        return lambda p, *a: vjit.evaluate(g, dict(zip(names, a)), p,
                                           list(c.leaves))

    arg_names = {r: [n for n, _ in vjit._HOOK_ARGS[r]] for r in c.graphs}
    traced = torch_variants.AttentionVariant(
        name="traced", use_softmax=variant.use_softmax,
        **{r: graph_hook(r, arg_names[r]) for r in c.graphs})
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(n, h, D, generator=gen)
               for n, h in ((QO, HQ), (KV, HKV), (KV, HKV)))
    hooked, graphs = (flash_attention_plain(q, k, v, causal=True, variant=x,
                                            variant_params=params)
                      for x in (variant, traced))
    assert torch.equal(hooked[0], graphs[0])
    assert torch.equal(hooked[1], graphs[1])


_PROBE = r"""
extern "C" float probe_logits(float s, int q, int k, int h,
                              const UserParams* u) {
  return user_logits(s, q, k, h, *u);
}
extern "C" int probe_mask(int q, int k, int h, const UserParams* u) {
  return user_mask(q, k, h, *u) ? 1 : 0;
}
extern "C" float probe_q(float x, int h, const UserParams* u) {
  return user_q(x, h, *u);
}
extern "C" float probe_out(float x, int h, const UserParams* u) {
  return user_out(x, h, *u);
}
"""


def _host_probe(compiled, tmp_path):
    """The generated header compiled as host code with the system C++
    compiler (``env.cxx()``, the host runtime's) and loaded by ctypes:
    ``probe_*`` call its four functions with a ``UserParamsC`` pointing
    into CPU tensors."""
    header = compiled.header_path()
    src, lib = tmp_path / "probe.cc", tmp_path / "probe.so"
    src.write_text(f'#include "{header}"\n{_PROBE}')
    subprocess.run([cxx(), "-O2", "-std=c++17", "-fPIC", "-shared", "-Wall",
                    "-Werror", str(src), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.POINTER(vjit.UserParamsC), ctypes.c_int, ctypes.c_float
    for fn, args, res in (("probe_logits", [F, I, I, I, P], F),
                          ("probe_mask", [I, I, I, P], I),
                          ("probe_q", [F, I, P], F),
                          ("probe_out", [F, I, P], F)):
        getattr(dll, fn).argtypes = args
        getattr(dll, fn).restype = res
    return dll


@pytest.mark.parametrize("name", NAMES)
def test_header_compiled_as_host_code_equals_the_hook(name, tmp_path):
    """The generated functions, built by the system C++ compiler, over a
    grid of (s, q_pos, kv_pos, head) and of q / o values, against the
    hooks on the same numbers: to 1e-6 relative (libm against PyTorch's
    transcendental functions), masks exactly."""
    variant, params = _torch_variant(name)
    c = vjit.compile_variant(variant, params, "flash", HQ)
    probe = _host_probe(c, tmp_path)
    up, keep = c.user_params(params, torch.device("cpu"))
    s, q_pos, kv_pos, head, x = _grid()
    for role in c.graphs:
        want, _ = _hook_outputs(variant, params, role)
        if role == "logits_transform":
            idx = [(h, i, j) for h in range(HQ) for i in range(0, QO, 3)
                   for j in range(0, KV, 3)]
            got = torch.tensor([probe.probe_logits(
                float(s[h, i, j]), int(q_pos[i, 0]), int(kv_pos[0, j]), h,
                up) for h, i, j in idx])
            ref = torch.stack([want[h, i, j] for h, i, j in idx])
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
        elif role == "logits_mask":
            got = torch.tensor([[probe.probe_mask(int(q_pos[i, 0]), j, 0, up)
                                 for j in range(KV)] for i in range(QO)])
            assert torch.equal(got.bool(), want.expand(QO, KV))
        else:
            fn = probe.probe_q if role == "query_transform" else \
                probe.probe_out
            got = torch.tensor([[[fn(float(x[t, h, e]), h, up)
                                  for e in range(D)] for h in range(HQ)]
                                for t in range(QO)])
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _scaled(c, cap=None):
    def logits(p, s, qp, kp, h):
        return s * c if cap is None else cap * torch.tanh(s * c / cap)
    return torch_variants.AttentionVariant(name="scaled",
                                           logits_transform=logits)


@pytest.mark.parametrize("a,b,same", [
    ((2.0,), (2.0,), True), ((2.0,), (3.0,), False),
    ((2.0, 30.0), (2.0, 30.0), True), ((2.0, 30.0), (2.0, 31.0), False)])
def test_build_keys(a, b, same):
    """Two variants of equal hooks (distinct function objects) share a key
    and so a build; a changed closure constant (a literal of the header)
    gives another."""
    ka = vjit.compile_variant(_scaled(*a), None, "flash", HQ).key
    kb = vjit.compile_variant(_scaled(*b), None, "flash", HQ).key
    assert (ka == kb) == same
    ha = vjit.compile_variant(_scaled(*a), None, "flash", HQ).header_path()
    hb = vjit.compile_variant(_scaled(*b), None, "flash", HQ).header_path()
    assert (jit.core._lib_path(("flash_attention", ha))
            == jit.core._lib_path(("flash_attention", hb))) == same
    assert jit.core._lib_path(("flash_attention", ha)) != \
        jit.core._lib_path("flash_attention")


class _CudaMarked(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: the kernels'
    wrappers take their CUDA branch on it (dispatch only)."""

    @property
    def is_cuda(self):
        return True


# (hook role, the hook, the op the refusal names)
REFUSED = {
    "reduction": ("logits_transform",
                  lambda p, s, qp, kp, h: s - s.amax(), "amax"),
    "dim_argument": ("logits_transform",
                     lambda p, s, qp, kp, h: torch.softmax(s, dim=-1),
                     "softmax"),
    "matmul": ("query_transform", lambda p, x: torch.matmul(x, x),
               "matmul"),
    "matmul_operator": ("output_transform", lambda p, o: o @ o, "@"),
    "python_branch": ("logits_mask",
                      lambda p, qp, kp, h: kp <= qp if h > 0 else kp >= 0,
                      "branch"),
    "half": ("logits_transform", lambda p, s, qp, kp, h: s.half(), "half"),
    "int64_leaf": ("logits_mask",
                   lambda p, qp, kp, h: p["ids"][kp] > 0, "int64"),
    "indexing_a_value": ("logits_transform",
                         lambda p, s, qp, kp, h: s[0], "indexing"),
    "unindexed_table": ("logits_transform",
                        lambda p, s, qp, kp, h: s + p["ids32"], "without"),
    "math_module": ("query_transform", lambda p, x: math.exp(x),
                    "conversion"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_construct_raises_before_any_build(case, monkeypatch):
    """A hook outside the traced subset raises NotImplementedError naming
    its op, on a CUDA-marked call to the flash and the paged wrapper,
    before any library is built or loaded."""
    role, hook, op = REFUSED[case]

    def no_build(*a, **k):
        raise AssertionError("a build was attempted")

    monkeypatch.setattr(jit, "load", no_build)
    monkeypatch.setattr(jit.core, "build_all", no_build)
    variant = torch_variants.AttentionVariant(name=case, **{role: hook})
    params = {"ids": torch.arange(KV + 64),
              "ids32": torch.arange(KV + 64, dtype=torch.int32)}
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(n, h, D, generator=gen).as_subclass(_CudaMarked)
               for n, h in ((QO, HQ), (KV, HKV), (KV, HKV)))
    with pytest.raises(NotImplementedError, match=f"variant JIT.*{op}"):
        flash.flash_attention_dense(q, k, v, causal=True, variant=variant,
                                    variant_params=params)
    if role == "output_transform":  # the paged kernel applies none
        return
    w = torch_batch.BatchDecodeWithPagedKVCacheWrapper(device="cpu")
    w.plan(np.array([0, 3]), np.arange(3), np.array([8]), HQ, HKV, D, 16)
    dp = w.device_plan
    qp = torch.randn(HKV, dp.meta.bucket_rows, D)
    cache = torch.randn(3, 16, HKV, D)
    args = [t.as_subclass(_CudaMarked) for t in (
        qp, cache, cache, dp.segment("kv_indices"), dp.segment("plan"))]
    with pytest.raises(NotImplementedError, match=f"variant JIT.*{op}"):
        paged.batch_paged_attention_run(
            *args, tile_q=dp.meta.tile_q, group=HQ // HKV, causal=False,
            sm_scale=D ** -0.5, variant=variant, variant_params=params)


def test_per_head_leaves():
    """``p[name][:, None]`` reads the row's head in the flash kernel's q
    and output transforms; the paged kernel takes none (JAX's sees whole
    leaves against its packed tile), nor does a logits hook."""
    params = {"qs": torch.rand(HQ) + 0.5}
    var = torch_variants.AttentionVariant(
        name="per_head", query_transform=lambda p, x: x * p["qs"][:, None])
    c = vjit.compile_variant(var, params, "flash", HQ)
    assert "[head]" in c.header
    want, args = _hook_outputs(var, params, "query_transform")
    assert torch.equal(vjit.evaluate(c.graphs["query_transform"], args,
                                     params, list(c.leaves)), want)
    with pytest.raises(NotImplementedError, match="per-head"):
        vjit.compile_variant(var, params, "paged", HQ)
    bad = torch_variants.AttentionVariant(
        name="per_head_logits",
        logits_transform=lambda p, s, qp, kp, h: s * p["qs"][:, None])
    with pytest.raises(NotImplementedError, match="per-head"):
        vjit.compile_variant(bad, params, "flash", HQ)


# -------------------------------------------------------- against JAX

def _qkv(seed, qo=QO, kv=KV, hq=HQ, hkv=HKV):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((qo, hq, D), (kv, hkv, D), (kv, hkv, D))]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_single_prefill_matches_jax(name):
    """Each variant through ``single_prefill_with_kv_cache`` (the plain
    version on the CPU) against JAX's flash kernel in interpret mode with
    the same hooks in jnp; the output transform against JAX's oracle,
    which applies it (its kernel drops it under softmax: the next test)."""
    q, k, v = _qkv(NAMES.index(name))
    tvar, tparams = _torch_variant(name)
    jvar, jparams = _jax_variant(name)
    got = single_prefill_with_kv_cache(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        variant=tvar, variant_params=tparams, return_lse=True)
    jkw = dict(causal=True, variant=jvar, variant_params=jparams)
    if name == "q_out":
        want = jax_reference.attention_reference(
            *(jnp.asarray(x) for x in (q, k, v)), **jkw)
    else:
        want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                         interpret=True, **jkw)
    _close(got, want)


def test_jax_flash_kernel_drops_the_output_transform_under_softmax():
    """A quirk of the reference: JAX's flash kernel applies
    ``output_transform`` only without softmax (kernels/flash.py:248-250),
    its oracle always (reference.py:143-144). The port applies it always,
    as the oracle and FlashInfer do."""
    q, k, v = (jnp.asarray(x) for x in _qkv(3, 8, 16, 4, 4))
    plus = jax_variants.AttentionVariant(
        name="plus", output_transform=lambda p, o: o + 1.0)
    kernel, _ = jax_flash(q, k, v, causal=True, variant=plus,
                          interpret=True)
    plain, _ = jax_flash(q, k, v, causal=True, interpret=True)
    oracle, _ = jax_reference.attention_reference(q, k, v, causal=True,
                                                  variant=plus)
    assert float(jnp.abs(kernel - plain).max()) == 0.0
    np.testing.assert_allclose(np.asarray(oracle), np.asarray(plain) + 1.0,
                               rtol=TOL, atol=TOL)
    tplus = torch_variants.AttentionVariant(
        name="plus", output_transform=lambda p, o: o + 1.0)
    ours, _ = flash.flash_attention_dense(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v)), causal=True,
        variant=tplus)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


def _paged_batch(mode, rng, ps=8):
    """(plan args, q, JAX's cache, the port's cache) of a small batch."""
    if mode == "decode":
        kv_lens = np.array([30, 17, 45])
        qo_lens = np.ones(3, np.int64)
    else:
        kv_lens = np.array([30, 20])
        qo_lens = np.array([11, 6])
    pages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    total = int(indptr[-1]) + 3
    indices = rng.permutation(total)[: indptr[-1]]
    last = kv_lens - (pages - 1) * ps
    kv = [rng.standard_normal((total, HKV, ps, D)).astype(np.float32)
          for _ in range(2)]
    q = rng.standard_normal((int(qo_lens.sum()), HQ, D)).astype(np.float32)
    args = (indptr, indices, last, HQ, HKV, D, ps)
    if mode != "decode":
        args = (np.concatenate([[0], np.cumsum(qo_lens)]),) + args
    return args, q, tuple(jnp.asarray(x) for x in kv), \
        tuple(torch.from_numpy(x) for x in kv)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("name", [n for n in NAMES if n != "sigmoid"])
def test_batch_wrappers_match_jax(name, mode):
    """Each softmax variant through the batch prefill and decode wrappers
    (the paged kernel's plain version) against JAX's wrappers on their
    Pallas kernel in interpret mode, f32 o and lse to 2e-5. The paged
    kernels of both apply no output transform, so q_out is held to JAX's
    kernel as it is."""
    rng = np.random.default_rng([NAMES.index(name), mode == "decode"])
    args, q, jc, tc = _paged_batch(mode, rng)
    cls = ("BatchDecodeWithPagedKVCacheWrapper" if mode == "decode"
           else "BatchPrefillWithPagedKVCacheWrapper")
    tvar, tparams = _torch_variant(name, n=64)
    jvar, jparams = _jax_variant(name, n=64)
    jw = getattr(jax_batch, cls)(kv_layout="HND", backend="pallas",
                                 variant=jvar)
    tw = getattr(torch_batch, cls)(kv_layout="HND", device="cpu",
                                   variant=tvar)
    kw = dict(kv_chunk_size=16)
    if mode != "decode":
        kw["causal"] = True
    jw.plan(*args, variant_params=jparams, **kw)
    tw.plan(*args, variant_params=tparams, **kw)
    got = tw.run(torch.from_numpy(q), tc, return_lse=True)
    want = jw.run(jnp.asarray(q), jc, return_lse=True, interpret=True)
    _close(got, want)
    if name == "q_out":  # the output transform is not applied
        plain = torch_variants.AttentionVariant(
            name="q_only", query_transform=tvar.query_transform)
        tw2 = getattr(torch_batch, cls)(kv_layout="HND", device="cpu",
                                        variant=plain)
        tw2.plan(*args, variant_params=tparams, **kw)
        assert torch.equal(tw2.run(torch.from_numpy(q), tc), got[0])


# ------------------------------------------- the sigmoid at bias -1

def _sigmoid_cases(bias, seed=0, qo=8, kv=700, hq=4, d=64):
    """bf16 q, k, v (one kv head) and the sigmoid's o four ways: the port's
    plain version, JAX's kernel in interpret mode, an emulation of the card
    kernel's rounding (S in f32 a 128-key tile at a time, the weight in
    f32, rounded to bf16, o summed in f32 tile by tile), and float64 (the
    exact function, and with its weights rounded to bf16)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16() for s in ((qo, hq, d), (kv, 1, d), (kv, 1, d)))
    sm = d ** -0.5
    plain, _ = flash_attention_plain(
        q, k, v, causal=True, sm_scale=sm,
        variant=torch_variants.FlashSigmoid(1.0, bias))
    jo, _ = jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                        for x in (q, k, v)), causal=True, sm_scale=sm,
                      variant=jax_variants.FlashSigmoid(1.0, bias),
                      interpret=True)
    keep = (torch.arange(kv)[None] <= kv - qo + torch.arange(qo)[:, None])
    acc = torch.zeros(qo, hq, d)
    for t0 in range(0, kv, 128):
        ks = slice(t0, min(kv, t0 + 128))
        s = torch.einsum("qhd,kd->hqk", q.float(), k[ks, 0].float()) * sm
        w = torch.reciprocal(1.0 + torch.exp(-(s + bias)))
        w = torch.where(keep[:, ks][None], w, 0.0).bfloat16().float()
        acc += torch.einsum("hqk,kd->qhd", w, v[ks, 0].float())
    s64 = torch.einsum("qhd,kd->hqk", q.double(), k[:, 0].double()) * sm
    w64 = torch.where(keep[None], 1.0 / (1.0 + torch.exp(-(s64 + bias))),
                      0.0)
    exact = torch.einsum("hqk,kd->qhd", w64, v[:, 0].double())
    rounded = torch.einsum("hqk,kd->qhd", w64.bfloat16().double(),
                           v[:, 0].double())
    outs = dict(plain=plain.double(), jax=torch.from_numpy(
        np.asarray(jo, np.float32)).double(), kernel=acc.bfloat16().double())
    return outs, exact, rounded


def _ratio(x, ref):
    """Largest error over the card's bf16 o limit, 2^-6 |ref| + 2^-8."""
    return float(((x - ref).abs() / (2.0 ** -6 * ref.abs() + 2.0 ** -8))
                 .max())


@pytest.mark.parametrize("bias", [-1.0, -math.log(700)])
def test_sigmoid_at_bias_minus_one_is_the_limit_not_the_kernel(bias):
    """The card kernel's rounding, emulated, is as far from float64 as
    JAX's kernel and the plain version are: at bias -1 over 700 keys all
    three lie ~7.7x the bf16 o limit from the exact function (a row's
    weights sum to ~190, and each is rounded to bf16, as the TPU feeds its
    MXU; one weight rounded the other way moves o by 2^-9 |v|, up to ~1.5x
    the limit's 2^-8 where o is near 0), and within it of float64 with
    the weights rounded to bf16; at bias -log n (weights summing to ~1) all
    are within the limit. Not a kernel fault: the card test keeps -log n."""
    outs, exact, rounded = _sigmoid_cases(bias)
    to_exact = {n: _ratio(x, exact) for n, x in outs.items()}
    to_rounded = {n: _ratio(x, rounded) for n, x in outs.items()}
    assert to_exact["kernel"] <= 1.05 * to_exact["jax"], to_exact
    assert max(to_rounded.values()) < 1.0, to_rounded
    if bias == -1.0:
        assert min(to_exact.values()) > 4.0, to_exact
    else:
        assert max(to_exact.values()) < 1.0, to_exact
