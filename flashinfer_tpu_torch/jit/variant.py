"""The variant JIT: a caller's ``AttentionVariant`` compiled into the flash
and paged CUDA kernels.

Counterpart of the reference's ``flashinfer/jit/attention/variants.py``,
which renders a user's C++ functor into a kernel template and builds it
with nvcc; the JAX package traces the same Python hooks into its Pallas
kernels. Here each hook is traced once, by a small proxy tracer, into an
expression graph over scalars, and the graph becomes one scalar function
per hook in a generated header:

  float user_logits(float s, int q_pos, int kv_pos, int head,
                    const UserParams&)
  bool  user_mask(int q_pos, int kv_pos, int head, const UserParams&)
  float user_q(float x, int head, const UserParams&)
  float user_out(float x, int head, const UserParams&)

``csrc/flash_attention.cu`` and ``csrc/paged_attention.cu`` take the header
by ``-include`` under ``-DFI_USER_VARIANT``; ``jit.core`` builds each
(kernel, header) pair once, keyed by the hash of the header, the kernel's
sources and the flags, into ``env.CACHE_DIR``.

What a hook may use is elementwise math, so that evaluating it element by
element equals its broadcast math on tensors:

- ``+ - * / // % **``, negation and ``abs``; comparisons; ``& | ~``;
- ``torch.where``, ``minimum`` / ``maximum`` / ``clamp``;
- ``exp``, ``exp2``, ``log``, ``log2``, ``tanh``, ``sigmoid``,
  ``reciprocal``, ``sqrt``, ``rsqrt``, ``sin``, ``cos``;
- ``.float()`` / ``.int()`` / ``.bool()`` and ``.to`` those dtypes;
- Python numbers (closure constants become literals of the header, so
  they key the build);
- leaves of ``variant_params`` (a dict, list or tuple of them): a Python
  number or a one-element f32/int32 tensor read as a scalar, or a 1-D
  f32/int32 tensor indexed by an int expression (``p["slopes"][head_idx]``,
  ``p["doc"][kv_pos]``). In ``query_transform`` and ``output_transform``
  of the flash kernel, ``p[name][:, None]`` of a leaf of one entry a query
  head reads the row's head (JAX's flash kernel blocks such leaves to the
  head).

Everything else raises ``NotImplementedError`` naming the op and the hook,
before any build: a reduction or a ``dim=`` argument, a matmul, a Python
branch on a traced value, another dtype, indexing a traced value, a tensor
made inside the hook. The positions a hook sees are those of the plain
versions: the absolute query position, key position and query head
(int32 on the card).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import operator
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flashinfer_tpu_torch.jit.env import CACHE_DIR

__all__ = [
    "MAX_LEAVES",
    "CompiledVariant",
    "UserParamsC",
    "Expr",
    "compile_variant",
    "evaluate",
    "needs_jit",
    "trace_hook",
]

MAX_LEAVES = 8  # leaves a UserParams carries (csrc: UserParams)
_KINDS = {"b": 0, "i": 1, "f": 2}  # bool < int32 < float32
_DTYPE_KIND = {torch.float32: "f", torch.int32: "i", torch.bool: "b"}
_KIND_DTYPE = {v: k for k, v in _DTYPE_KIND.items()}
_CTYPE = {"f": "float", "i": "int", "b": "bool"}
# the hooks' argument lists: (name, kind) of each traced argument
_HOOK_ARGS = {
    "logits_transform": (("s", "f"), ("q_pos", "i"), ("kv_pos", "i"),
                         ("head", "i")),
    "logits_mask": (("q_pos", "i"), ("kv_pos", "i"), ("head", "i")),
    "query_transform": (("x", "f"),),
    "output_transform": (("x", "f"),),
}
_HOOK_FN = {"logits_transform": "user_logits", "logits_mask": "user_mask",
            "query_transform": "user_q", "output_transform": "user_out"}
_FN_ARGS = {"user_logits": "float s, int q_pos, int kv_pos, int head",
            "user_mask": "int q_pos, int kv_pos, int head",
            "user_q": "float x, int head", "user_out": "float x, int head"}


# ------------------------------------------------------------- the graph

@dataclasses.dataclass(frozen=True, eq=False)
class Expr:
    """One node of a traced hook: ``op`` over ``args`` (nodes or Python
    values), of ``kind`` "f" (float32), "i" (int32) or "b" (bool)."""

    op: str
    args: tuple
    kind: str


def _refuse(hook: str, what: str):
    from flashinfer_tpu_torch.ops.attention.variants import VARIANT_JIT

    raise NotImplementedError(
        f"variant JIT: hook {hook!r} uses {what}, which the CUDA kernels "
        f"cannot take ({VARIANT_JIT})")


class _Ctx:
    """The hook being traced: its name, the leaves read so far, and what a
    per-head read may use."""

    def __init__(self, hook: str, num_qo_heads: int, per_head: bool):
        self.hook = hook
        self.num_qo_heads = num_qo_heads
        self.per_head = per_head
        self.leaves: "List[_Leaf]" = []

    def leaf(self, path: tuple, value: Any) -> int:
        for i, lf in enumerate(self.leaves):
            if lf.path == path:
                return i
        if len(self.leaves) == MAX_LEAVES:
            _refuse(self.hook, f"more than {MAX_LEAVES} leaves of "
                               f"variant_params")
        self.leaves.append(_Leaf.of(path, value, self.hook))
        return len(self.leaves) - 1


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A leaf of ``variant_params``: its path, and how it travels: a
    Python number by value ("val"), a tensor by pointer ("ptr")."""

    path: tuple
    where: str  # "val" | "ptr"
    kind: str
    numel: int
    ndim: int

    @staticmethod
    def of(path: tuple, value: Any, hook: str) -> "_Leaf":
        if isinstance(value, bool):
            return _Leaf(path, "val", "b", 1, 0)
        if isinstance(value, int):
            return _Leaf(path, "val", "i", 1, 0)
        if isinstance(value, float):
            return _Leaf(path, "val", "f", 1, 0)
        if isinstance(value, torch.Tensor):
            if value.dtype not in (torch.float32, torch.int32):
                _refuse(hook, f"a leaf {_path_str(path)} of dtype "
                              f"{value.dtype} (f32 or int32 only)")
            if value.dim() > 1 and value.numel() != 1:
                _refuse(hook, f"a leaf {_path_str(path)} of shape "
                              f"{tuple(value.shape)} (1-D tables only)")
            return _Leaf(path, "ptr", _DTYPE_KIND[value.dtype],
                         value.numel(), value.dim())
        _refuse(hook, f"a leaf {_path_str(path)} of type "
                      f"{type(value).__name__}")


def _path_str(path: tuple) -> str:
    return "params" + "".join(f"[{k!r}]" for k in path)


def _kind_of_py(v) -> str:
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    return "f"


def _promote(*kinds: str) -> str:
    return max(kinds, key=_KINDS.__getitem__)


# ----------------------------------------------------------- the proxies

class _Traced:
    """What a hook sees in place of a tensor: every operation on it records
    a node."""

    __slots__ = ("expr", "ctx")
    __hash__ = object.__hash__

    def __init__(self, expr: Expr, ctx: _Ctx):
        self.expr = expr
        self.ctx = ctx

    # --- torch functions on a traced value
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ctx = _find_ctx(args, kwargs)
        return _call(ctx, func, args, kwargs)

    @property
    def dtype(self):
        return _KIND_DTYPE[self.expr.kind]

    def __getattr__(self, name):
        if name.startswith("__"):  # protocols (numpy's, copy's) are absent
            raise AttributeError(name)
        method = _METHODS.get(name)
        if method is None:
            what = ("a reduction" if name in _REDUCTIONS else
                    "a matmul" if name in _MATMULS else
                    "a cast to an unsupported dtype" if name in _CASTS
                    else "the method")
            _refuse(self.ctx.hook, f"{what} '.{name}'")
        return lambda *a, **k: method(self.ctx, self, *a, **k)

    def __bool__(self):
        _refuse(self.ctx.hook, "a Python branch on a traced value (bool())")

    def __index__(self):
        _refuse(self.ctx.hook, "a Python conversion of a traced value "
                               "(int() / float() / math.*)")

    __int__ = __float__ = __index__

    def __getitem__(self, idx):
        _refuse(self.ctx.hook, "indexing a traced value")

    def __matmul__(self, other):
        _refuse(self.ctx.hook, "a matmul '@'")

    __rmatmul__ = __matmul__

    def __neg__(self):
        return _unary(self.ctx, "neg", self)

    def __abs__(self):
        return _unary(self.ctx, "abs", self)

    def __invert__(self):
        return _unary(self.ctx, "not", self)


def _binop(op: str, reflected: bool = False):
    def f(self, other):
        a, b = (other, self) if reflected else (self, other)
        return _binary(self.ctx, op, a, b)
    return f


for _name, _op in (("add", "add"), ("sub", "sub"), ("mul", "mul"),
                   ("truediv", "div"), ("floordiv", "floordiv"),
                   ("mod", "mod"), ("pow", "pow"), ("and", "and"),
                   ("or", "or"), ("xor", "xor")):
    setattr(_Traced, f"__{_name}__", _binop(_op))
    setattr(_Traced, f"__r{_name}__", _binop(_op, reflected=True))
for _name, _op in (("lt", "lt"), ("le", "le"), ("gt", "gt"), ("ge", "ge"),
                   ("eq", "eq"), ("ne", "ne")):
    setattr(_Traced, f"__{_name}__", _binop(_op))


class _Params:
    """``variant_params`` as a hook sees it: containers stay proxies,
    leaves become ``_LeafRef``s."""

    def __init__(self, value: Any, path: tuple, ctx: _Ctx):
        self._value, self._path, self._ctx = value, path, ctx

    def _child(self, key):
        v = self._value
        if v is None:
            _refuse(self._ctx.hook, "variant_params, which is None")
        try:
            child = v[key]
        except (KeyError, IndexError, TypeError):
            _refuse(self._ctx.hook, f"{_path_str(self._path + (key,))}, "
                                    f"which variant_params does not hold")
        path = self._path + (key,)
        if isinstance(child, (Mapping, list, tuple)):
            return _Params(child, path, self._ctx)
        return _LeafRef(self._ctx, self._ctx.leaf(path, child))

    def __getitem__(self, key):
        return self._child(key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        _refuse(self._ctx.hook, f"attribute '.{name}' of variant_params "
                                f"(index a dict, list or tuple)")


# a per-head read of a 1-D leaf: [hq] as [hq, 1] (q, o of [.., hq, d]) or
# [1, hq, 1]
_PER_HEAD = ((slice(None), None), (None, slice(None), None))


class _LeafRef(_Traced):
    """A leaf: indexing it reads the table; using it whole reads it as a
    scalar (one element), or, when ``per_head``, at the row's head."""

    __slots__ = ("index", "cast", "per_head_idx")

    def __init__(self, ctx, index, cast=None, per_head_idx=None):
        self.ctx = ctx
        self.index = index
        self.cast = cast
        self.per_head_idx = per_head_idx

    @property
    def _spec(self) -> _Leaf:
        return self.ctx.leaves[self.index]

    def _cast(self, e: Expr) -> Expr:
        return e if self.cast is None else Expr("cast", (e,), self.cast)

    @property
    def expr(self) -> Expr:  # the leaf used whole
        spec = self._spec
        if self.per_head_idx is not None:
            return self._cast(Expr("head_read",
                                   (self.index, self.per_head_idx),
                                   spec.kind))
        if spec.numel == 1:
            return self._cast(Expr("leaf", (self.index,), spec.kind))
        if spec.ndim == 1 and spec.numel == self.ctx.num_qo_heads \
                and self.ctx.per_head:
            _refuse(self.ctx.hook, f"{_path_str(spec.path)} of "
                                   f"{spec.numel} entries without an index "
                                   f"(write [:, None] for a per-head read)")
        _refuse(self.ctx.hook, f"{_path_str(spec.path)} of {spec.numel} "
                               f"entries without an index")

    def __getitem__(self, idx):
        spec = self._spec
        if isinstance(idx, tuple) and idx in _PER_HEAD and spec.ndim == 1:
            if not self.ctx.per_head:
                _refuse(self.ctx.hook, f"a per-head read "
                                       f"{_path_str(spec.path)}[:, None] "
                                       f"(index it with head_idx "
                                       f"in logits hooks; the paged kernel "
                                       f"takes no per-head leaf in "
                                       f"query_transform)")
            if spec.numel != self.ctx.num_qo_heads:
                _refuse(self.ctx.hook, f"{_path_str(spec.path)}[:, None] of "
                                       f"{spec.numel} entries for "
                                       f"{self.ctx.num_qo_heads} query heads")
            return _LeafRef(self.ctx, self.index, self.cast, idx)
        if spec.where != "ptr" or spec.ndim != 1 or self.per_head_idx:
            _refuse(self.ctx.hook, f"indexing {_path_str(spec.path)} "
                                   f"(1-D tensor leaves only)")
        if isinstance(idx, bool) or not isinstance(idx, (int, _Traced)):
            _refuse(self.ctx.hook, f"index {idx!r} of "
                                   f"{_path_str(spec.path)}")
        i = _as_expr(self.ctx, idx)
        if i.kind != "i":
            _refuse(self.ctx.hook, f"a {_KIND_DTYPE[i.kind]} index of "
                                   f"{_path_str(spec.path)}")
        return _Traced(self._cast(Expr("read", (self.index, i), spec.kind)),
                       self.ctx)

    def _with_cast(self, kind: str) -> "_LeafRef":
        return _LeafRef(self.ctx, self.index, kind, self.per_head_idx)

    def __getattr__(self, name):
        if name in ("float", "int", "bool"):
            return lambda: self._with_cast({"float": "f", "int": "i",
                                            "bool": "b"}[name])
        if name == "to":
            return lambda *a, **k: self._with_cast(
                _dtype_kind(self.ctx, _to_dtype(a, k)))
        return _Traced(self.expr, self.ctx).__getattr__(name)


def _find_ctx(args, kwargs) -> _Ctx:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, _Traced):
            return a.ctx
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, _Traced):
                    return b.ctx
    raise AssertionError("no traced argument")


def _as_expr(ctx: _Ctx, v) -> Expr:
    if isinstance(v, _Traced):
        return v.expr
    if isinstance(v, np.generic) and v.dtype.kind in "biuf":
        v = v.item()
    if isinstance(v, (bool, int, float)):
        if isinstance(v, int) and not isinstance(v, bool) \
                and not -2 ** 31 <= v < 2 ** 31:
            _refuse(ctx.hook, f"the integer {v}, outside int32")
        return Expr("const", (v,), _kind_of_py(v))
    if isinstance(v, torch.Tensor):
        if v.dim() == 0 and v.dtype in _DTYPE_KIND:
            return Expr("const", (v.clone(),), _DTYPE_KIND[v.dtype])
        _refuse(ctx.hook, f"a tensor of shape {tuple(v.shape)} and dtype "
                          f"{v.dtype} made or captured by the hook")
    _refuse(ctx.hook, f"a value of type {type(v).__name__}")


def _dtype_kind(ctx: _Ctx, dtype) -> str:
    if dtype not in _DTYPE_KIND:
        _refuse(ctx.hook, f"the dtype {dtype}")
    return _DTYPE_KIND[dtype]


def _to_dtype(a, k):
    for x in list(a) + list(k.values()):
        if isinstance(x, torch.dtype):
            return x
    return None


_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}
_BITS = {"and", "or", "xor"}
_MATH = {"exp", "exp2", "log", "log2", "tanh", "sigmoid", "reciprocal",
         "sqrt", "rsqrt", "sin", "cos"}


def _binary(ctx: _Ctx, op: str, a, b) -> _Traced:
    x, y = _as_expr(ctx, a), _as_expr(ctx, b)
    if op in _CMP:
        kind = "b"
    elif op == "div":
        kind = "f"
    elif op in _BITS:
        if "f" in (x.kind, y.kind):
            _refuse(ctx.hook, f"'{op}' on a float")
        kind = _promote(x.kind, y.kind)
    else:
        if x.kind == "b" and y.kind == "b":
            _refuse(ctx.hook, f"'{op}' of two bools")
        kind = _promote(x.kind, y.kind)
    return _Traced(Expr(op, (x, y), kind), ctx)


def _unary(ctx: _Ctx, op: str, a) -> _Traced:
    x = _as_expr(ctx, a)
    if op in _MATH:
        kind = "f"
    elif op == "not":
        if x.kind == "f":
            _refuse(ctx.hook, "'~' on a float")
        kind = x.kind
    else:  # neg, abs
        if x.kind == "b":
            _refuse(ctx.hook, f"'{op}' of a bool")
        kind = x.kind
    return _Traced(Expr(op, (x,), kind), ctx)


def _cast(ctx: _Ctx, a, kind: str) -> _Traced:
    return _Traced(Expr("cast", (_as_expr(ctx, a),), kind), ctx)


def _where(ctx: _Ctx, cond, a, b) -> _Traced:
    c, x, y = (_as_expr(ctx, v) for v in (cond, a, b))
    if c.kind != "b":
        _refuse(ctx.hook, "torch.where on a condition that is not bool")
    return _Traced(Expr("where", (c, x, y), _promote(x.kind, y.kind)), ctx)


def _clamp(ctx: _Ctx, a, min=None, max=None) -> _Traced:
    x = _as_expr(ctx, a)
    lo = None if min is None else _as_expr(ctx, min)
    hi = None if max is None else _as_expr(ctx, max)
    kinds = [e.kind for e in (x, lo, hi) if e is not None]
    if "b" in kinds:
        _refuse(ctx.hook, "clamp of a bool")
    return _Traced(Expr("clamp", (x, lo, hi), _promote(*kinds)), ctx)


def _minmax(op):
    def f(ctx, a, b):
        x, y = _as_expr(ctx, a), _as_expr(ctx, b)
        if "b" in (x.kind, y.kind):
            _refuse(ctx.hook, f"{op} of a bool")
        return _Traced(Expr(op, (x, y), _promote(x.kind, y.kind)), ctx)
    return f


def _method_to(ctx, a, *args, **kwargs):
    dtype = _to_dtype(args, kwargs)
    if dtype is None:  # .to(device) and the like: the value is unchanged
        return a
    return _cast(ctx, a, _dtype_kind(ctx, dtype))


def _bin(op):
    return lambda ctx, a, b: _binary(ctx, op, a, b)


def _un(op):
    return lambda ctx, a: _unary(ctx, op, a)


_FUNCS: Dict[Callable, Callable] = {}
for _op in _MATH | {"abs", "neg"}:
    _FUNCS[getattr(torch, _op)] = _un(_op)
    _FUNCS[getattr(torch.Tensor, _op)] = _un(_op)
for _f, _op in ((torch.negative, "neg"), (torch.absolute, "abs"),
                (torch.special.expit, "sigmoid"), (torch.special.exp2, "exp2"),
                (torch.bitwise_not, "not")):
    _FUNCS[_f] = _un(_op)
# the logical functions take their operands as bools
_FUNCS[torch.logical_not] = lambda ctx, a: _unary(ctx, "not",
                                                  _cast(ctx, a, "b"))
for _f, _op in ((torch.add, "add"), (torch.sub, "sub"),
                (torch.subtract, "sub"), (torch.mul, "mul"),
                (torch.multiply, "mul"), (torch.div, "div"),
                (torch.true_divide, "div"), (torch.floor_divide, "floordiv"),
                (torch.remainder, "mod"), (torch.pow, "pow"),
                (torch.lt, "lt"), (torch.le, "le"), (torch.gt, "gt"),
                (torch.ge, "ge"), (torch.eq, "eq"), (torch.ne, "ne"),
                (torch.bitwise_and, "and"),
                (torch.bitwise_or, "or"), (torch.bitwise_xor, "xor")):
    _FUNCS[_f] = _bin(_op)
for _f, _op in ((torch.logical_and, "and"), (torch.logical_or, "or"),
                (torch.logical_xor, "xor")):
    _FUNCS[_f] = (lambda op: lambda ctx, a, b: _binary(
        ctx, op, _cast(ctx, a, "b"), _cast(ctx, b, "b")))(_op)
_FUNCS[torch.where] = _where
_FUNCS[torch.clamp] = _FUNCS[torch.clip] = _clamp
_FUNCS[torch.minimum] = _minmax("minimum")
_FUNCS[torch.maximum] = _minmax("maximum")
for _name in ("add", "sub", "mul", "div", "floor_divide", "remainder", "pow",
              "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
              "logical_or", "logical_not", "clamp", "clip", "minimum",
              "maximum"):
    _FUNCS[getattr(torch.Tensor, _name)] = _FUNCS[getattr(torch, _name)]
for _name, _op in (("__add__", "add"), ("__radd__", "add"),
                   ("__mul__", "mul"), ("__rmul__", "mul"),
                   ("__sub__", "sub"), ("__truediv__", "div"),
                   ("__floordiv__", "floordiv"), ("__mod__", "mod"),
                   ("__pow__", "pow"), ("__and__", "and"), ("__or__", "or"),
                   ("__xor__", "xor"), ("__lt__", "lt"), ("__le__", "le"),
                   ("__gt__", "gt"), ("__ge__", "ge"), ("__eq__", "eq"),
                   ("__ne__", "ne")):
    # a real tensor beside a traced value (a 0-d constant): tensor.__op__
    _FUNCS[getattr(torch.Tensor, _name)] = _bin(_op)
for _name, _op in (("__rsub__", "sub"), ("__rtruediv__", "div"),
                   ("__rfloordiv__", "floordiv"), ("__rmod__", "mod"),
                   ("__rpow__", "pow")):
    _FUNCS[getattr(torch.Tensor, _name)] = (
        lambda op: lambda ctx, a, b: _binary(ctx, op, b, a))(_op)

_METHODS: Dict[str, Callable] = {
    "float": lambda ctx, a: _cast(ctx, a, "f"),
    "int": lambda ctx, a: _cast(ctx, a, "i"),
    "bool": lambda ctx, a: _cast(ctx, a, "b"),
    "to": _method_to,
    "type_as": lambda ctx, a, other: _cast(ctx, a, _as_expr(ctx, other).kind),
    "clamp_min": lambda ctx, a, lo: _clamp(ctx, a, min=lo),
    "clamp_max": lambda ctx, a, hi: _clamp(ctx, a, max=hi),
}
for _op in _MATH | {"abs", "neg"}:
    _METHODS[_op] = _un(_op)
for _name in ("add", "sub", "mul", "div", "floor_divide", "remainder", "pow",
              "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
              "logical_or", "logical_not", "clamp", "clip", "minimum",
              "maximum"):
    _METHODS[_name] = _FUNCS[getattr(torch, _name)]
_METHODS["where"] = lambda ctx, a, cond, other: _where(ctx, cond, a, other)
_REDUCTIONS = {"sum", "mean", "max", "min", "amax", "amin", "prod", "cumsum",
               "logsumexp", "softmax", "log_softmax", "norm", "std", "var",
               "any", "all", "argmax", "argmin", "topk", "sort"}
_CASTS = {"half", "double", "long", "short", "bfloat16", "byte", "char",
          "cfloat", "cdouble"}
_MATMULS = {"matmul", "mm", "bmm", "einsum", "dot", "inner", "outer",
            "tensordot", "linear", "baddbmm", "addmm"}


def _call(ctx: _Ctx, func, args, kwargs):
    name = getattr(func, "__name__", repr(func))
    if name in _MATMULS:
        _refuse(ctx.hook, f"a matmul '{name}'")
    if "dim" in kwargs or name in _REDUCTIONS:
        _refuse(ctx.hook, f"a reduction '{name}'"
                + (" (a dim= argument)" if "dim" in kwargs else ""))
    impl = _FUNCS.get(func)
    if impl is None:
        _refuse(ctx.hook, f"the function '{name}'")
    try:
        return impl(ctx, *args, **kwargs)
    except TypeError as e:
        if "unexpected keyword" in str(e) or "positional" in str(e):
            _refuse(ctx.hook, f"'{name}' with arguments {list(kwargs)}")
        raise


# ------------------------------------------------------------ tracing

def trace_hook(hook_name: str, fn: Callable, params: Any,
               num_qo_heads: int, *, per_head: bool = False
               ) -> Tuple[Expr, List[_Leaf]]:
    """Trace one hook into its expression graph; returns (graph, leaves it
    reads). ``per_head`` lets ``p[name][:, None]`` read the row's head."""
    ctx = _Ctx(hook_name, num_qo_heads, per_head)
    args = [_Traced(Expr("arg", (n,), k), ctx)
            for n, k in _HOOK_ARGS[hook_name]]
    out = fn(_Params(params, (), ctx), *args)
    try:
        e = _as_expr(ctx, out)
    except NotImplementedError:
        _refuse(hook_name, f"a result of type {type(out).__name__}")
    if hook_name == "logits_mask":
        if e.kind != "b":
            _refuse(hook_name, f"a {_KIND_DTYPE[e.kind]} result (a mask is "
                               f"bool)")
    elif e.kind != "f":
        e = Expr("cast", (e,), "f")
    return e, ctx.leaves


# ------------------------------------------------------------ evaluation

_EVAL_BIN = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod, "pow": operator.pow, "and": operator.and_,
    "or": operator.or_, "xor": operator.xor, "lt": operator.lt,
    "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "eq": operator.eq, "ne": operator.ne, "minimum": torch.minimum,
    "maximum": torch.maximum,
}


def _leaf_value(params: Any, path: tuple):
    v = params
    for k in path:
        v = v[k]
    return v


def evaluate(expr: Expr, args: Dict[str, Any], params: Any,
             leaves: List[_Leaf]):
    """The graph on tensors: each node replays the torch operation it was
    traced from, so the result equals the hook's (the tests hold it bit
    for bit)."""
    memo: Dict[int, Any] = {}

    def ev(e):
        if not isinstance(e, Expr):
            return e
        if id(e) in memo:
            return memo[id(e)]
        op, a = e.op, e.args
        if op == "arg":
            r = args[a[0]]
        elif op == "const":
            r = a[0]
        elif op == "leaf":
            r = _leaf_value(params, leaves[a[0]].path)
        elif op == "read":
            r = _leaf_value(params, leaves[a[0]].path)[ev(a[1])]
        elif op == "head_read":
            r = _leaf_value(params, leaves[a[0]].path)[a[1]]
        elif op == "cast":
            r = ev(a[0])
            r = (r.to(_KIND_DTYPE[e.kind]) if isinstance(r, torch.Tensor)
                 else {"f": float, "i": int, "b": bool}[e.kind](r))
        elif op in _EVAL_BIN:
            r = _EVAL_BIN[op](ev(a[0]), ev(a[1]))
        elif op == "where":
            r = torch.where(ev(a[0]), ev(a[1]), ev(a[2]))
        elif op == "clamp":
            r = torch.clamp(ev(a[0]), min=ev(a[1]), max=ev(a[2]))
        elif op == "not":
            r = ~ev(a[0])
        elif op == "neg":
            r = -ev(a[0])
        elif op == "abs":
            r = abs(ev(a[0]))
        else:  # the math functions
            r = getattr(torch, op)(ev(a[0]))
        memo[id(e)] = r
        return r

    return ev(expr)


# ------------------------------------------------------------ codegen

def _flit(v: float) -> str:
    f = float(np.float32(v))
    if math.isnan(f):
        return "fi_nan()"
    if math.isinf(f):
        return "fi_inf()" if f > 0 else "(-fi_inf())"
    return f"{f.hex()}f"


def _const(v, kind: str) -> str:
    if isinstance(v, torch.Tensor):
        v = v.item()
    if kind == "f":
        return _flit(v)
    if kind == "b":
        return "true" if v else "false"
    return f"({int(v)})"


def _conv(code: str, src: str, dst: str) -> str:
    if src == dst:
        return code
    if dst == "b":
        return f"({code} != 0)"
    return f"{_CTYPE[dst]}({code})"


_C_BIN = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
          "ne": "!="}
_C_MATH = {"exp": "expf({})", "exp2": "exp2f({})", "log": "logf({})",
           "log2": "log2f({})", "tanh": "tanhf({})", "sqrt": "sqrtf({})",
           "sin": "sinf({})", "cos": "cosf({})",
           "sigmoid": "fi_fdiv(1.f, fi_fadd(1.f, expf(-({}))))",
           "reciprocal": "fi_fdiv(1.f, {})",
           "rsqrt": "fi_fdiv(1.f, sqrtf({}))"}


def _emit(expr: Expr, leaves: List[_Leaf], ret: str) -> List[str]:
    """Lines of a function body computing ``expr``, one const a node."""
    lines: List[str] = []
    names: Dict[int, str] = {}

    def leaf_ptr(i):
        return (f"static_cast<const {_CTYPE[leaves[i].kind]}*>(u.ptr[{i}])")

    def go(e: Expr) -> str:
        if id(e) in names:
            return names[id(e)]
        op, a, k = e.op, e.args, e.kind
        if op == "arg":
            return a[0]
        if op == "const":
            return _const(a[0], k)
        if op == "leaf":
            lf = leaves[a[0]]
            if lf.where == "val":
                code = (f"u.f[{a[0]}]" if lf.kind == "f"
                        else f"(u.i[{a[0]}] != 0)" if lf.kind == "b"
                        else f"u.i[{a[0]}]")
            else:
                code = f"{leaf_ptr(a[0])}[0]"
        elif op == "read":
            code = f"{leaf_ptr(a[0])}[{go(a[1])}]"
        elif op == "head_read":
            code = f"{leaf_ptr(a[0])}[head]"
        elif op == "cast":
            code = _conv(go(a[0]), a[0].kind, k)
        elif op in ("add", "sub", "mul", "div"):
            x, y = (_conv(go(v), v.kind, "f" if op == "div" else k)
                    for v in a)
            if k == "f" or op == "div":
                code = f"fi_f{op}({x}, {y})"
            else:
                code = f"({x} {'+-*'['add sub mul'.split().index(op)]} {y})"
        elif op in ("floordiv", "mod", "pow", "minimum", "maximum"):
            x, y = (_conv(go(v), v.kind, k) for v in a)
            code = f"fi_{'f' if k == 'f' else 'i'}{op}({x}, {y})"
        elif op in _C_BIN:
            kk = _promote(a[0].kind, a[1].kind)
            x, y = (_conv(go(v), v.kind, kk) for v in a)
            code = f"({x} {_C_BIN[op]} {y})"
        elif op in _BITS:
            x, y = (_conv(go(v), v.kind, k) for v in a)
            sym = {"and": "&&", "or": "||", "xor": "!="}[op] if k == "b" \
                else {"and": "&", "or": "|", "xor": "^"}[op]
            code = f"({x} {sym} {y})"
        elif op == "not":
            code = f"(!{go(a[0])})" if k == "b" else f"(~{go(a[0])})"
        elif op == "neg":
            code = f"(-{go(a[0])})"
        elif op == "abs":
            code = f"fabsf({go(a[0])})" if k == "f" else f"fi_iabs({go(a[0])})"
        elif op == "where":
            c, x, y = go(a[0]), *(_conv(go(v), v.kind, k) for v in a[1:])
            code = f"({c} ? {x} : {y})"
        elif op == "clamp":
            x = _conv(go(a[0]), a[0].kind, k)
            t = "f" if k == "f" else "i"
            if a[1] is not None:
                x = f"fi_{t}maximum({x}, {_conv(go(a[1]), a[1].kind, k)})"
            if a[2] is not None:
                x = f"fi_{t}minimum({x}, {_conv(go(a[2]), a[2].kind, k)})"
            code = x
        else:  # the math functions, on f32
            code = _C_MATH[op].format(_conv(go(a[0]), a[0].kind, "f"))
        name = f"t{len(names)}"
        names[id(e)] = name
        lines.append(f"  const {_CTYPE[k]} {name} = {code};")
        return name

    out = go(expr)
    lines.append(f"  return {_conv(out, expr.kind, ret)};")
    return lines


_PRELUDE = r"""#pragma once
#include <math.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifdef __CUDACC__
#define FI_HD __host__ __device__ __forceinline__
#else
#define FI_HD inline
#endif

// The caller's leaves: tensors by pointer (ptr), numbers by value (f, i).
struct UserParams {
  const void* ptr[%(n)d];
  float f[%(n)d];
  int i[%(n)d];
};

// Float arithmetic rounded operation by operation, as PyTorch rounds it
// (no contraction into FMAs on the card).
#ifdef __CUDA_ARCH__
FI_HD float fi_fadd(float a, float b) { return __fadd_rn(a, b); }
FI_HD float fi_fsub(float a, float b) { return __fsub_rn(a, b); }
FI_HD float fi_fmul(float a, float b) { return __fmul_rn(a, b); }
FI_HD float fi_fdiv(float a, float b) { return __fdiv_rn(a, b); }
#else
FI_HD float fi_fadd(float a, float b) { return a + b; }
FI_HD float fi_fsub(float a, float b) { return a - b; }
FI_HD float fi_fmul(float a, float b) { return a * b; }
FI_HD float fi_fdiv(float a, float b) { return a / b; }
#endif
#ifdef __CUDA_ARCH__
FI_HD float fi_inf() { return __int_as_float(0x7f800000); }
FI_HD float fi_nan() { return __int_as_float(0x7fffffff); }
#else
FI_HD float fi_inf() { return HUGE_VALF; }
FI_HD float fi_nan() { return NAN; }
#endif
// Python's floor division and modulo, and the rest, as PyTorch has them.
FI_HD float fi_ffloordiv(float a, float b) { return floorf(fi_fdiv(a, b)); }
FI_HD float fi_fmod(float a, float b) {
  float r = fmodf(a, b);
  return (r != 0.f && ((r < 0.f) != (b < 0.f))) ? r + b : r;
}
FI_HD float fi_fpow(float a, float b) {
  return b == 2.f ? fi_fmul(a, a) : powf(a, b);
}
FI_HD float fi_fminimum(float a, float b) { return fminf(a, b); }
FI_HD float fi_fmaximum(float a, float b) { return fmaxf(a, b); }
FI_HD int fi_ifloordiv(int a, int b) {
  const int q = a / b;
  return (a %% b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
FI_HD int fi_imod(int a, int b) {
  const int r = a %% b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
FI_HD int fi_ipow(int a, int b) {
  int r = 1;
  for (; b > 0; --b) r *= a;
  return r;
}
FI_HD int fi_iminimum(int a, int b) { return a < b ? a : b; }
FI_HD int fi_imaximum(int a, int b) { return a > b ? a : b; }
FI_HD int fi_iabs(int a) { return a < 0 ? -a : a; }
"""


@dataclasses.dataclass(frozen=True)
class CompiledVariant:
    """A traced variant for one kernel: the generated header, its key (the
    header's hash), the leaves a launch passes and each hook's graph."""

    name: str
    kernel: str  # "flash" | "paged"
    header: str
    key: str
    leaves: Tuple[_Leaf, ...]
    graphs: Dict[str, Expr]
    softmax: bool

    def header_path(self) -> Path:
        """The header on disk (``CACHE_DIR/variant-<key>.h``), written once."""
        path = CACHE_DIR / f"variant-{self.key}.h"
        if not path.exists():
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(self.header)
            os.replace(tmp, path)
        return path

    @property
    def mask_reads_head(self) -> bool:
        """Whether the mask hook reads its ``head`` argument (a tile map of
        the mask is then built per kv head)."""
        e = self.graphs.get("logits_mask")
        return e is not None and _reads(e, "head")

    def user_params(self, variant_params: Any,
                    device: Optional[torch.device] = None):
        """(ctypes ``UserParams``, the tensors it points into): the leaves of
        ``variant_params`` as a launch takes them, tensors on ``device``.
        Keep the tensors alive until the launch is enqueued."""
        up = UserParamsC()
        keep = []
        for i, lf in enumerate(self.leaves):
            v = _leaf_value(variant_params, lf.path)
            if lf.where == "val":
                if lf.kind == "f":
                    up.f[i] = float(v)
                else:
                    up.i[i] = int(v)
                continue
            t = v.to(device=device, dtype=_KIND_DTYPE[lf.kind]).contiguous()
            keep.append(t)
            up.ptr[i] = t.data_ptr()
        return up, keep


def _reads(expr: Expr, name: str) -> bool:
    """Whether the graph reads the hook argument ``name``."""
    seen, todo = set(), [expr]
    while todo:
        e = todo.pop()
        if not isinstance(e, Expr) or id(e) in seen:
            continue
        seen.add(id(e))
        if e.op == "arg" and e.args[0] == name:
            return True
        todo.extend(e.args)
    return False


class UserParamsC(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * MAX_LEAVES),
                ("f", ctypes.c_float * MAX_LEAVES),
                ("i", ctypes.c_int * MAX_LEAVES)]


def needs_jit(variant, kernel: str) -> bool:
    """Whether ``variant`` has hooks a built-in kernel path does not run:
    no ``KernelVariant``, or a query transform, a logit mask or (flash
    only) an output transform of the caller's own."""
    hooks = [variant.query_transform, variant.logits_mask]
    if kernel == "flash":
        hooks.append(variant.output_transform)
    return variant.kernel is None or any(h is not None for h in hooks)


def _signature(v: Any):
    if isinstance(v, Mapping):
        return ("M", tuple((k, _signature(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("S", tuple(_signature(x) for x in v))
    if isinstance(v, torch.Tensor):
        return ("T", v.dtype, v.dim(), v.numel() if v.dim() <= 1 else -1)
    return ("N", type(v).__name__)


_compiled: Dict[tuple, CompiledVariant] = {}


def compile_variant(variant, variant_params: Any, kernel: str,
                    num_qo_heads: int) -> CompiledVariant:
    """Trace ``variant``'s hooks for ``kernel`` ("flash" or "paged") into a
    header; a variant, kernel, head count and params structure seen before
    returns its earlier result without tracing. The paged kernel takes no
    output transform (as JAX's) and needs softmax."""
    key = (variant, kernel, num_qo_heads, _signature(variant_params))
    hit = _compiled.get(key)
    if hit is not None:
        return hit
    roles = ["logits_transform", "logits_mask", "query_transform"]
    if kernel == "flash":
        roles.append("output_transform")
    leaves: List[_Leaf] = []
    graphs: Dict[str, Expr] = {}
    for role in roles:
        fn = getattr(variant, role)
        if fn is None:
            continue
        per_head = kernel == "flash" and role in ("query_transform",
                                                  "output_transform")
        e, hook_leaves = trace_hook(role, fn, variant_params, num_qo_heads,
                                    per_head=per_head)
        graphs[role] = _renumber(e, hook_leaves, leaves)
    if len(leaves) > MAX_LEAVES:
        _refuse("variant", f"more than {MAX_LEAVES} leaves of variant_params")
    header = _header(variant, kernel, graphs, leaves)
    compiled = CompiledVariant(
        name=variant.name, kernel=kernel, header=header,
        key=hashlib.sha256(header.encode()).hexdigest()[:16],
        leaves=tuple(leaves), graphs=graphs, softmax=variant.use_softmax)
    _compiled[key] = compiled
    return compiled


def _renumber(e: Expr, local: List[_Leaf], shared: List[_Leaf]) -> Expr:
    """``e`` with its leaf numbers moved from the hook's list to the
    variant's (one list across its hooks)."""
    index = {}
    for i, lf in enumerate(local):
        if lf not in shared:
            shared.append(lf)
        index[i] = shared.index(lf)
    memo: Dict[int, Expr] = {}

    def go(x):
        if not isinstance(x, Expr):
            return x
        if id(x) not in memo:
            args = tuple(go(a) for a in x.args)
            if x.op in ("leaf", "read", "head_read"):
                args = (index[x.args[0]],) + args[1:]
            memo[id(x)] = Expr(x.op, args, x.kind)
        return memo[id(x)]

    return go(e)


def _header(variant, kernel: str, graphs: Dict[str, Expr],
            leaves: List[_Leaf]) -> str:
    has = {role: role in graphs for role in _HOOK_FN}
    parts = [f"// Generated by flashinfer_tpu_torch/jit/variant.py from "
             f"the variant {variant.name!r}\n// for the {kernel} kernel. "
             f"Leaves:"]
    for i, lf in enumerate(leaves):
        parts.append(f"//   {i}: {_path_str(lf.path)} {lf.where} "
                     f"{_CTYPE[lf.kind]}")
    parts.append(_PRELUDE % {"n": MAX_LEAVES})
    parts.append(f"#define FI_USER_HAS_LOGITS {int(has['logits_transform'])}")
    parts.append(f"#define FI_USER_HAS_MASK {int(has['logits_mask'])}")
    parts.append(f"#define FI_USER_HAS_Q {int(has['query_transform'])}")
    parts.append(f"#define FI_USER_HAS_OUT {int(has['output_transform'])}")
    parts.append(f"#define FI_USER_SOFTMAX {int(variant.use_softmax)}\n")
    for role, fn in _HOOK_FN.items():
        ret = "bool" if role == "logits_mask" else "float"
        parts.append(f"FI_HD {ret} {fn}({_FN_ARGS[fn]}, "
                     f"const UserParams& u) {{")
        used = {n for n, _ in _HOOK_ARGS[role]}
        for arg in _FN_ARGS[fn].split(", "):
            parts.append(f"  (void){arg.split()[-1]};")
        parts.append("  (void)u;")
        if role in graphs:
            parts.extend(_emit(graphs[role], leaves, ret[0]))
        else:  # identity
            parts.append("  return true;" if role == "logits_mask" else
                         "  return s;" if "s" in used else "  return x;")
        parts.append("}\n")
    return "\n".join(parts)
