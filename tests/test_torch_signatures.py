"""Signature parity: every named parameter of the JAX package's public
callables is a named parameter of the port's counterpart.

Each module of JAX's package that declares ``__all__`` is walked: its
functions, and its classes' ``__init__``, ``plan`` and ``run``. A JAX
parameter must be a named parameter of the port's callable of the same
path; a ``**kwargs`` that swallows it does not count, since a caller's
keyword would then be dropped silently. The only exceptions are
``TPU_ONLY_PARAMS``: TPU mechanics with no counterpart on the card, each
with its reason, and each still used by some JAX callable (a stale entry
fails). The names themselves are ``tests/test_torch_surface.py``'s."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import flashinfer_tpu

# parameter name, or "callable.parameter" for one callable: why the port
# has no counterpart
TPU_ONLY_PARAMS = {
    "interpret": "Pallas's interpret switch: a CPU tensor takes each "
                 "kernel's plain version, a CUDA tensor its kernel",
    "tile_q": "a TPU kernel's VMEM tile (flash_attention_dense): the CUDA "
              "kernel's tiles are fixed by its design",
    "tile_k": "a TPU kernel's VMEM key tile: the CUDA kernels' key tiles are "
              "fixed by their design",
    "tn": "the Pallas grouped GEMM's N tile: the CUDA kernel picks its own",
    "tk": "the Pallas grouped GEMM's K tile: the CUDA kernel picks its own",
    "key": "a jax.random key: the port takes seed= / generator=",
    "make_mesh.devices": "a list of JAX devices: rank r is device r under "
                         "torch.distributed",
    "batch_paged_attention_run.plan_arrays": "the TPU kernel's scalar-"
                                             "prefetch arrays: the port's "
                                             "entry takes the plan blob",
    "batch_paged_attention_run.plan_meta": "the TPU kernel's static plan: "
                                           "the port's entry takes tile_q, "
                                           "group and causal",
    "batch_paged_attention_run.kv_dequant": "the TPU kernel's int8 decode "
                                            "mode: the port's entry reads "
                                            "the cache's dtype",
    "batch_paged_attention_run.ragged": "the TPU kernel's contiguous-KV "
                                        "DMA mode: ragged KV is planned as "
                                        "pages of one token and repacked",
}
METHODS = ("__init__", "plan", "run")


def _jax_modules():
    names = []
    for info in pkgutil.walk_packages(flashinfer_tpu.__path__,
                                      "flashinfer_tpu."):
        if hasattr(importlib.import_module(info.name), "__all__"):
            names.append(info.name)
    return sorted(names)


JAX_MODULES = _jax_modules()


def _pairs(modname):
    """(qualified name, short name, JAX callable, port callable) of every
    public function and class method the module exports."""
    mod = importlib.import_module(modname)
    ours = importlib.import_module(
        "flashinfer_tpu_torch." + modname[len("flashinfer_tpu."):])
    for n in mod.__all__:
        j, t = getattr(mod, n, None), getattr(ours, n, None)
        if j is None or t is None:  # the surface test holds the names
            continue
        if inspect.isclass(j):
            for meth in METHODS:
                if meth in j.__dict__ or (meth != "__init__"
                                          and hasattr(j, meth)):
                    yield (f"{n}.{meth}", n, getattr(j, meth),
                           getattr(t, meth, None))
        elif callable(j):
            yield n, n, j, t


def _named(fn):
    """The names of fn's parameters that a keyword can reach, or None
    where Python cannot say (a builtin)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return {p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD,
                              p.POSITIONAL_ONLY)}


def _missing(modname):
    """{qualified callable: JAX parameters the port's lacks}, and the
    TPU_ONLY_PARAMS entries that excused one."""
    missing, used = {}, set()
    for qual, short, j, t in _pairs(modname):
        want = _named(j)
        if not want:
            continue
        have = _named(t) if t is not None else set()
        assert have is not None, f"{qual}: the port's signature is unreadable"
        base = qual.rsplit(".", 1)[0] if "." in qual else short
        lack = []
        for name in sorted(want - have - {"self", "cls"}):
            for entry in (f"{base}.{name}", f"{short}.{name}", name):
                if entry in TPU_ONLY_PARAMS:
                    used.add(entry)
                    break
            else:
                lack.append(name)
        if lack:
            missing[qual] = lack
    return missing, used


@pytest.mark.parametrize("modname", JAX_MODULES)
def test_jax_parameters_are_named_in_the_port(modname):
    missing, _ = _missing(modname)
    assert missing == {}


def test_tpu_only_params_hold_only_tpu_mechanics():
    """Every entry excuses some JAX parameter (none is stale), and the
    table holds these TPU mechanics and nothing else."""
    used = set()
    for modname in JAX_MODULES:
        used |= _missing(modname)[1]
    assert used == set(TPU_ONLY_PARAMS)
    assert set(TPU_ONLY_PARAMS) == {
        "interpret", "tile_q", "tile_k", "tn", "tk", "key",
        "make_mesh.devices", "batch_paged_attention_run.plan_arrays",
        "batch_paged_attention_run.plan_meta",
        "batch_paged_attention_run.kv_dequant",
        "batch_paged_attention_run.ragged"}


def test_keyword_calls_reach_the_port():
    """Calls by JAX's keyword names compute: ``e4m3_bits_to_bf16(b_int8=)``
    and the prefill wrapper's ``plan`` with the page table's names, the
    same plan as a positional call."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchPrefillWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.ops.fp8 import e4m3_bits_to_bf16

    bits = torch.tensor([0x38, 0x40, -72, 0], dtype=torch.int8)
    assert e4m3_bits_to_bf16(b_int8=bits).tolist() == [1.0, 2.0, -1.0, 0.0]

    args = dict(qo_indptr=np.asarray([0, 3, 5]),
                paged_kv_indptr=np.asarray([0, 2, 3]),
                paged_kv_indices=np.asarray([4, 1, 0]),
                paged_kv_last_page_len=np.asarray([5, 7]), num_qo_heads=4,
                num_kv_heads=2, head_dim_qk=16, page_size=8)
    by_kw = BatchPrefillWithPagedKVCacheWrapper(device="cpu").plan(
        **args, causal=True).device_plan
    by_pos = BatchPrefillWithPagedKVCacheWrapper(device="cpu").plan(
        *args.values(), causal=True).device_plan
    assert by_kw.meta == by_pos.meta
    assert torch.equal(by_kw.blob, by_pos.blob)
