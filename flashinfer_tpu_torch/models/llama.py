"""Llama-family model definition: configuration, random weights, the dense
f32 forward that serves as the serving engine's oracle, a paged decode step
with injected attention and append functions, and the bridge from the JAX
package's parameter dict.

Counterpart of ``flashinfer_tpu/models/llama.py``. Weights are a flat dict
of tensors in the ``x @ w`` layout: per-layer weights stacked on a leading
[num_layers] axis, projections stored [in, out].

8-bit weights (the serving engine's ``weight_dtype``) keep the JAX
package's names and layouts: each matmul weight W [..., in, out] becomes
8-bit values of the same shape plus one f32 scale an output channel,
[..., 1, out], under ``name + "_scale"`` for e4m3 (``torch.float8_e4m3fn``:
the bits of JAX's int8 containers) or ``name + "_iscale"`` for linear int8
(amax / 127). Embedding and norms stay in the model dtype. Only the engine
reads them (``_wmm``); the dense paths refuse them, as JAX's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from flashinfer_tpu_torch.ops.activation import silu_and_mul
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.norm import rmsnorm, rmsnorm_plain
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.utils import resolve_device, tensor_from_numpy

__all__ = [
    "LlamaConfig",
    "llama_init_weights",
    "llama_init_weights_fp8",
    "llama_init_weights_int8",
    "quantize_llama_weights_fp8",
    "quantize_llama_weights_int8",
    "llama_forward_dense",
    "llama_decode_step",
    "params_from_numpy",
    "e4m3_views",
]

PER_LAYER = ("wqkv", "wq", "wk", "wv", "wo", "w_gate_up", "w_down",
             "attn_norm", "mlp_norm")
# the matmul weights that 8-bit containers quantize
_FP8_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w_gate_up", "w_down", "lm_head")
SCALE_SUFFIXES = ("_scale", "_iscale")
_E4M3_MAX, _INT8_MAX = 448.0, 127.0
# values quantized at a time: one layer, in slabs of output columns, so the
# f32 temporaries stay at ~256 MB (a stacked f32 w_gate_up of Llama-3-8B
# alone is 15 GB)
_SLAB_VALUES = 1 << 26


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_qo_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 5e5
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B at its published widths, 128256-entry vocabulary."""
        return LlamaConfig(vocab_size=128256)

    @staticmethod
    def tiny(dtype: torch.dtype = torch.float32) -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, hidden_size=128,
                           intermediate_size=256, num_layers=2,
                           num_qo_heads=4, num_kv_heads=2, head_dim=32,
                           dtype=dtype)


def llama_init_weights(generator: torch.Generator, cfg: LlamaConfig,
                       device: str | torch.device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """Random weights, normal with std 1/sqrt(hidden), drawn in the model
    dtype on ``device`` from ``generator`` (which must live on that
    device). Norm weights are ones."""
    device = resolve_device(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv, L = cfg.num_qo_heads, cfg.num_kv_heads, cfg.num_layers
    scale = 1.0 / math.sqrt(h)

    def rnd(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    return {
        "embedding": rnd(cfg.vocab_size, h),
        "wq": rnd(L, h, hq * d),
        "wk": rnd(L, h, hkv * d),
        "wv": rnd(L, h, hkv * d),
        "wo": rnd(L, hq * d, h),
        "w_gate_up": rnd(L, h, 2 * i),
        "w_down": rnd(L, i, h),
        "attn_norm": ones(L, h),
        "mlp_norm": ones(L, h),
        "final_norm": ones(h),
        "lm_head": rnd(h, cfg.vocab_size),
    }


def _quantize_slab(w: torch.Tensor, linear: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] -> (8-bit [in, out], f32 scale [1, out]) with scale =
    amax / 448 (e4m3) or amax / 127 (linear int8) an output channel."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-30) / (_INT8_MAX if linear else _E4M3_MAX)
    if linear:
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    else:
        q = (wf / scale).to(torch.float8_e4m3fn)
    return q, scale


def _quantize_weight(w: torch.Tensor, linear: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W [..., in, out] -> (8-bit [..., in, out], f32 [..., 1, out]), one
    layer and one slab of output columns at a time."""
    *lead, d_in, d_out = w.shape
    q = torch.empty(w.shape, device=w.device,
                    dtype=torch.int8 if linear else torch.float8_e4m3fn)
    scale = torch.empty(*lead, 1, d_out, dtype=torch.float32, device=w.device)
    w3, q3 = w.reshape(-1, d_in, d_out), q.view(-1, d_in, d_out)
    s3 = scale.view(-1, 1, d_out)
    step = max(1, _SLAB_VALUES // d_in)
    for layer in range(w3.shape[0]):
        for c in range(0, d_out, step):
            q3[layer, :, c:c + step], s3[layer, :, c:c + step] = (
                _quantize_slab(w3[layer, :, c:c + step], linear))
    return q, scale


def _quantize_params(params: Mapping[str, torch.Tensor], linear: bool
                     ) -> Dict[str, torch.Tensor]:
    suffix = "_iscale" if linear else "_scale"
    out: Dict[str, torch.Tensor] = {}
    for name, w in params.items():
        if name in _FP8_WEIGHT_NAMES:
            out[name], out[name + suffix] = _quantize_weight(w, linear)
        else:
            out[name] = w
    return out


def quantize_llama_weights_fp8(params: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """The matmul weights (``_FP8_WEIGHT_NAMES``) as e4m3 with one f32
    scale an output channel (amax / 448) under ``name + "_scale"``; the
    engine computes y = (x @ decode(w)) * scale. The rest unchanged
    (flashinfer_tpu/models/llama.py:306)."""
    return _quantize_params(params, linear=False)


def quantize_llama_weights_int8(params: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """The matmul weights as linear int8 (round(w / scale), clipped to
    +-127) with one f32 scale an output channel (amax / 127) under
    ``name + "_iscale"`` (flashinfer_tpu/models/llama.py:331)."""
    return _quantize_params(params, linear=True)


def _init_weights_8bit(generator: torch.Generator, cfg: LlamaConfig,
                       device, linear: bool) -> Dict[str, torch.Tensor]:
    """Random weights quantized as they are drawn: each layer's matmul
    weight (and the lm_head, a slab of columns at a time) is drawn in f32,
    normal with std 1/sqrt(hidden), and quantized, so no full-width copy of
    the weights exists. Embedding drawn as ``llama_init_weights`` draws it;
    norms ones."""
    device = resolve_device(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv, L = cfg.num_qo_heads, cfg.num_kv_heads, cfg.num_layers
    scale0 = 1.0 / math.sqrt(h)
    suffix = "_iscale" if linear else "_scale"

    def draw(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(scale0)

    def empty(*shape):
        return (torch.empty(shape, device=device,
                            dtype=torch.int8 if linear
                            else torch.float8_e4m3fn),
                torch.empty(*shape[:-2], 1, shape[-1], device=device,
                            dtype=torch.float32))

    params = {"embedding": torch.randn(
        cfg.vocab_size, h, generator=generator, device=device,
        dtype=cfg.dtype).mul_(scale0)}
    for name, d_in, d_out in (("wq", h, hq * d), ("wk", h, hkv * d),
                              ("wv", h, hkv * d), ("wo", hq * d, h),
                              ("w_gate_up", h, 2 * i), ("w_down", i, h)):
        q, sc = empty(L, d_in, d_out)
        for layer in range(L):
            q[layer], sc[layer] = _quantize_slab(draw(d_in, d_out), linear)
        params[name], params[name + suffix] = q, sc
    q, sc = empty(h, cfg.vocab_size)
    step = max(1, _SLAB_VALUES // h)
    for c in range(0, cfg.vocab_size, step):
        n = min(step, cfg.vocab_size - c)
        q[:, c:c + n], sc[:, c:c + n] = _quantize_slab(draw(h, n), linear)
    params["lm_head"], params["lm_head" + suffix] = q, sc
    for name in ("attn_norm", "mlp_norm"):
        params[name] = torch.ones(L, h, device=device, dtype=cfg.dtype)
    params["final_norm"] = torch.ones(h, device=device, dtype=cfg.dtype)
    return params


def llama_init_weights_fp8(generator: torch.Generator, cfg: LlamaConfig,
                           device: str | torch.device = "cuda"
                           ) -> Dict[str, torch.Tensor]:
    """Random e4m3 weights drawn and quantized a layer at a time, the scheme
    of ``quantize_llama_weights_fp8`` (flashinfer_tpu/models/llama.py:232).
    ``generator`` lives on ``device``."""
    return _init_weights_8bit(generator, cfg, device, linear=False)


def llama_init_weights_int8(generator: torch.Generator, cfg: LlamaConfig,
                            device: str | torch.device = "cuda"
                            ) -> Dict[str, torch.Tensor]:
    """Random linear-int8 weights drawn and quantized a layer at a time,
    the scheme of ``quantize_llama_weights_int8``
    (flashinfer_tpu/models/llama.py:348)."""
    return _init_weights_8bit(generator, cfg, device, linear=True)


def check_dense_params(params: Mapping[str, torch.Tensor]) -> None:
    """The dense paths do raw ``x @ w`` matmuls, so 8-bit containers would
    give wrong results: they are engine-only, as in JAX
    (flashinfer_tpu/models/llama.py:104)."""
    bad = [k for k in params if k.endswith(SCALE_SUFFIXES)]
    if bad:
        raise ValueError(
            f"dense llama paths take unquantized weights; got quantized "
            f"containers (scale keys {bad[:3]}...) - use the serving engine")
    wo = params.get("wo")
    if wo is not None and wo.dtype in (torch.int8, torch.uint8,
                                       torch.float8_e4m3fn):
        raise ValueError(
            "dense llama paths take unquantized weights; got 8-bit weight "
            "containers - use the serving engine (_wmm dequant path)")


def params_from_numpy(np_params: Mapping[str, np.ndarray],
                      device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat parameter dict (numpy arrays, [L, in, out]
    layout) as the port's tensors on ``device``, same names and layout.
    JAX's int8 containers of e4m3 bits (a ``_scale`` key beside them)
    become ``torch.float8_e4m3fn`` views of the same bytes; linear int8
    (``_iscale``) stays int8."""
    device = resolve_device(device)
    return e4m3_views({name: tensor_from_numpy(arr, device)
                       for name, arr in np_params.items()})


def e4m3_views(params: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 containers of e4m3 bits (a weight with a
    ``_scale`` key beside it) as ``torch.float8_e4m3fn`` views; linear int8
    (``_iscale``) and everything else unchanged."""
    return {name: (t.view(torch.float8_e4m3fn)
                   if name + "_scale" in params and t.dtype == torch.int8
                   else t) for name, t in params.items()}


def llama_forward_dense(params: Mapping[str, torch.Tensor],
                        token_ids: torch.Tensor,
                        cfg: LlamaConfig) -> torch.Tensor:
    """Dense causal forward, token_ids [batch, seq] -> logits [batch, seq,
    vocab] f32. The oracle for the serving engine: plain PyTorch
    throughout (the norm runs its plain version)."""
    check_dense_params(params)
    B, S = token_ids.shape
    d, hq, hkv = cfg.head_dim, cfg.num_qo_heads, cfg.num_kv_heads
    pos = torch.arange(S, device=token_ids.device)
    x = params["embedding"][token_ids]  # [B, S, h]
    for layer in range(cfg.num_layers):
        lp = {k: params[k][layer] for k in PER_LAYER if k in params}
        xn = rmsnorm_plain(x, lp["attn_norm"], cfg.rms_eps)
        if "wqkv" in lp:
            qkv = xn @ lp["wqkv"]
            q = qkv[..., : hq * d]
            k = qkv[..., hq * d: (hq + hkv) * d]
            v = qkv[..., (hq + hkv) * d:]
        else:
            q, k, v = xn @ lp["wq"], xn @ lp["wk"], xn @ lp["wv"]
        q = q.reshape(B, S, hq, d)
        k = k.reshape(B, S, hkv, d)
        v = v.reshape(B, S, hkv, d)
        attn = []
        for b in range(B):
            qb, kb = apply_rope_pos_ids(q[b], k[b], pos,
                                        rope_theta=cfg.rope_theta)
            attn.append(attention_reference(qb, kb, v[b], causal=True)[0])
        attn = torch.stack(attn)  # [B, S, hq, d]
        x = x + (attn.reshape(B, S, hq * d) @ lp["wo"]).to(x.dtype)
        xn = rmsnorm_plain(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + (silu_and_mul(xn @ lp["w_gate_up"]) @ lp["w_down"]).to(x.dtype)
    x = rmsnorm_plain(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"]).float()


def llama_decode_step(
    params: Mapping[str, torch.Tensor],
    cfg: LlamaConfig,
    token_ids: torch.Tensor,  # [batch] current tokens
    positions: torch.Tensor,  # [batch] their positions
    kv_caches: Tuple[torch.Tensor, torch.Tensor],  # [L, pages, ...] x 2
    kv_indices: torch.Tensor,
    kv_indptr: torch.Tensor,
    kv_last_page_len: torch.Tensor,
    attention_fn: Callable,
    append_fn: Callable,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step over paged caches, counterpart of JAX's
    ``llama_decode_step`` (models/llama.py:177).

    ``append_fn(layer, k, v, k_cache, v_cache) -> (k_cache, v_cache)`` and
    ``attention_fn(layer, q, k_cache, v_cache) -> out [batch, hq, d]`` come
    from the caller, which planned the step; the page table arguments are
    theirs to read. Takes wq/wk/wv weights. Returns (logits [batch, vocab]
    f32, the caches stacked as [L, ...] again)."""
    check_dense_params(params)
    B = token_ids.shape[0]
    d, hq, hkv = cfg.head_dim, cfg.num_qo_heads, cfg.num_kv_heads
    x = params["embedding"][token_ids]  # [B, h]
    k_all, v_all = kv_caches
    new_k, new_v = [], []
    for layer in range(cfg.num_layers):
        xn = rmsnorm(x, params["attn_norm"][layer], cfg.rms_eps)
        q = (xn @ params["wq"][layer]).reshape(B, hq, d)
        k = (xn @ params["wk"][layer]).reshape(B, hkv, d)
        v = (xn @ params["wv"][layer]).reshape(B, hkv, d)
        q, k = apply_rope_pos_ids(q, k, positions, rope_theta=cfg.rope_theta)
        kc, vc = append_fn(layer, k, v, k_all[layer], v_all[layer])
        new_k.append(kc)
        new_v.append(vc)
        attn = attention_fn(layer, q, kc, vc)  # [B, hq, d]
        x = x + (attn.reshape(B, hq * d) @ params["wo"][layer]).to(x.dtype)
        xn = rmsnorm(x, params["mlp_norm"][layer], cfg.rms_eps)
        x = x + (silu_and_mul(xn @ params["w_gate_up"][layer])
                 @ params["w_down"][layer]).to(x.dtype)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, (torch.stack(new_k), torch.stack(new_v))
