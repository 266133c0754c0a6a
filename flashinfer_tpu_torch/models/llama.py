"""Llama-family model definition: configuration, random weights, the dense
f32 forward that serves as the serving engine's oracle, a paged decode step
with injected attention and append functions, and the bridge from the JAX
package's parameter dict.

Counterpart of ``flashinfer_tpu/models/llama.py``. Weights are a flat dict
of tensors in the ``x @ w`` layout: per-layer weights stacked on a leading
[num_layers] axis, projections stored [in, out].
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
    "llama_forward_dense",
    "llama_decode_step",
    "params_from_numpy",
]

PER_LAYER = ("wqkv", "wq", "wk", "wv", "wo", "w_gate_up", "w_down",
             "attn_norm", "mlp_norm")


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


def check_dense_params(params: Mapping[str, torch.Tensor]) -> None:
    """8-bit weight containers are not in this slice of the port."""
    bad = [k for k in params if k.endswith("_scale") or k.endswith("_iscale")]
    wo = params.get("wo")
    if bad or (wo is not None and wo.dtype in (torch.int8, torch.uint8)):
        raise NotImplementedError(
            "8-bit weight containers (weight_dtype fp8_e4m3 / int8) are not "
            "in this slice of the port (ROADMAP Queue 1, item 1)")


def params_from_numpy(np_params: Mapping[str, np.ndarray],
                      device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat parameter dict (numpy arrays, [L, in, out]
    layout) as the port's tensors on ``device``, same names and layout."""
    device = resolve_device(device)
    out = {name: tensor_from_numpy(arr, device)
           for name, arr in np_params.items()}
    check_dense_params(out)
    return out


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
