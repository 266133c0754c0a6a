"""Mixtral-family model: GQA attention and a top-2 renormalized MoE FFN.

Counterpart of flashinfer_tpu/models/mixtral.py, with its structure and
weight layouts: a flat dict of tensors, per-layer weights stacked on a
leading [num_layers] axis, projections [in, out]; w13 [L, E, 2*inter,
hidden] (gate rows, then up rows) and w2 [L, E, hidden, inter], read in
place by the grouped GEMM; the router [L, hidden, E]. JAX's parameters
(numpy arrays) load with ``params_from_numpy``, DeepSeek's loader: same
names and layouts.

Two paths:
  * ``mixtral_forward_dense``: the dense causal oracle (plain norm, rope
    and ``attention_reference``; the MoE runs ``fused_moe``);
  * ``mixtral_decode_step``: one paged decode step over NHD caches through
    a planned ``BatchDecodeWithPagedKVCacheWrapper`` (the paged kernel) and
    ``append_paged_kv_cache``; ``fused_moe`` runs the grouped-GEMM kernel,
    and every norm after the first adds the residual in the norm kernel's
    launch (``fused_add_rmsnorm``: the same rounded sum JAX adds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from flashinfer_tpu_torch.models.deepseek import params_from_numpy
from flashinfer_tpu_torch.ops.attention.reference import attention_reference
from flashinfer_tpu_torch.ops.fused_moe import (
    RoutingMethodType,
    fused_moe,
    route_tokens,
)
from flashinfer_tpu_torch.ops.norm import (
    add_rmsnorm,
    fused_add_rmsnorm,
    rmsnorm_plain,
)
from flashinfer_tpu_torch.ops.page import append_paged_kv_cache
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.utils import resolve_device

__all__ = [
    "MixtralConfig",
    "mixtral_init_weights",
    "mixtral_forward_dense",
    "mixtral_decode_step",
    "params_from_numpy",
]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    """Defaults: Mixtral-8x7B's published widths (huggingface.co/mistralai/
    Mixtral-8x7B-v0.1, config.json)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_qo_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    num_experts: int = 8
    top_k: int = 2
    moe_inter_size: int = 14336
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(dtype: torch.dtype = torch.float32) -> "MixtralConfig":
        return MixtralConfig(vocab_size=128, hidden_size=64, num_layers=2,
                             num_qo_heads=4, num_kv_heads=2, head_dim=16,
                             num_experts=4, top_k=2, moe_inter_size=32,
                             dtype=dtype)


def mixtral_init_weights(generator: torch.Generator, cfg: MixtralConfig,
                         device: str | torch.device = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """Random weights, normal scaled as the JAX package's (1/sqrt(hidden),
    1 for the router), drawn in the model dtype on ``device`` from
    ``generator`` (which must live on that device), one layer at a time so
    no temporary outgrows a layer. Norm weights are ones."""
    device = resolve_device(device)
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    hq, hkv = cfg.num_qo_heads, cfg.num_kv_heads
    e, i = cfg.num_experts, cfg.moe_inter_size
    s = 1.0 / math.sqrt(h)

    def rnd(shape, scale=s, stacked=True):
        t = torch.empty(shape, device=device, dtype=cfg.dtype)
        for part in (t if stacked else (t,)):
            part.normal_(generator=generator).mul_(scale)
        return t

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    return {
        "embedding": rnd((cfg.vocab_size, h), stacked=False),
        "wq": rnd((L, h, hq * d)),
        "wk": rnd((L, h, hkv * d)),
        "wv": rnd((L, h, hkv * d)),
        "wo": rnd((L, hq * d, h)),
        "router": rnd((L, h, e), 1.0),
        "w13": rnd((L, e, 2 * i, h)),
        "w2": rnd((L, e, h, i)),
        "attn_norm": ones(L, h),
        "ffn_norm": ones(L, h),
        "final_norm": ones(h),
        "lm_head": rnd((h, cfg.vocab_size), stacked=False),
    }


def _moe_ffn(params, cfg, layer, xn):
    """Renormalize routing on f32 router logits, then ``fused_moe``."""
    ids, scales = route_tokens(
        xn.float() @ params["router"][layer].float(), cfg.top_k,
        RoutingMethodType.Renormalize)
    return fused_moe(xn, params["w13"][layer], params["w2"][layer], ids,
                     scales)


def mixtral_forward_dense(params: Mapping[str, torch.Tensor],
                          token_ids: torch.Tensor,
                          cfg: MixtralConfig) -> torch.Tensor:
    """Dense causal forward, token_ids [batch, seq] -> logits [batch, seq,
    vocab] f32."""
    B, S = token_ids.shape
    d, hq, hkv = cfg.head_dim, cfg.num_qo_heads, cfg.num_kv_heads
    x = params["embedding"][token_ids]
    pos = torch.arange(S, device=token_ids.device)
    for layer in range(cfg.num_layers):
        xn = rmsnorm_plain(x, params["attn_norm"][layer], cfg.rms_eps)
        q = (xn @ params["wq"][layer]).reshape(B, S, hq, d)
        k = (xn @ params["wk"][layer]).reshape(B, S, hkv, d)
        v = (xn @ params["wv"][layer]).reshape(B, S, hkv, d)
        attn = []
        for b in range(B):
            qb, kb = apply_rope_pos_ids(q[b], k[b], pos,
                                        rope_theta=cfg.rope_theta)
            attn.append(attention_reference(qb, kb, v[b], causal=True)[0])
        attn = torch.stack(attn).reshape(B, S, hq * d)
        x = x + (attn @ params["wo"][layer]).to(x.dtype)
        xn = rmsnorm_plain(x, params["ffn_norm"][layer], cfg.rms_eps)
        ffn = _moe_ffn(params, cfg, layer, xn.reshape(B * S, -1))
        x = x + ffn.reshape(B, S, -1).to(x.dtype)
    x = rmsnorm_plain(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"]).float()


def mixtral_decode_step(
    params: Mapping[str, torch.Tensor],
    cfg: MixtralConfig,
    token_ids: torch.Tensor,  # [batch]
    positions: torch.Tensor,  # [batch]
    kv_caches: Tuple[torch.Tensor, torch.Tensor],  # NHD [L, pages, ps,
    #                                                hkv, d] x 2
    kv_indices: torch.Tensor,
    kv_indptr: torch.Tensor,
    kv_last_page_len: torch.Tensor,
    decode_wrapper,  # planned BatchDecodeWithPagedKVCacheWrapper (NHD)
    *,
    moe_fn: Optional[Callable] = None,  # (params, cfg, layer, xn) -> ffn
    #   out; defaults to the single-device _moe_ffn (the JAX package's
    #   hook for an expert-parallel layer)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One paged decode step. Returns (logits [batch, vocab] f32, (k_cache,
    v_cache)): the new tokens' K and V are written into the caches in place
    and the same tensors are returned (JAX returns new ones)."""
    moe_fn = moe_fn or _moe_ffn
    B = token_ids.shape[0]
    d, hq, hkv = cfg.head_dim, cfg.num_qo_heads, cfg.num_kv_heads
    x = params["embedding"][token_ids]
    k_all, v_all = kv_caches
    batch_indices = torch.arange(B, dtype=torch.int32, device=x.device)
    ffn = None  # the sublayer output the next norm adds to x
    for layer in range(cfg.num_layers):
        xn, x = add_rmsnorm(ffn, x, params["attn_norm"][layer], cfg.rms_eps)
        q = (xn @ params["wq"][layer]).reshape(B, hq, d)
        k = (xn @ params["wk"][layer]).reshape(B, hkv, d)
        v = (xn @ params["wv"][layer]).reshape(B, hkv, d)
        q, k = apply_rope_pos_ids(q, k, positions, rope_theta=cfg.rope_theta)
        kc, vc = append_paged_kv_cache(
            k, v, batch_indices, positions, (k_all[layer], v_all[layer]),
            kv_indices, kv_indptr, kv_last_page_len, kv_layout="NHD")
        attn = decode_wrapper.run(q, (kc, vc))
        xn, x = fused_add_rmsnorm(
            (attn.reshape(B, hq * d) @ params["wo"][layer]).to(x.dtype), x,
            params["ffn_norm"][layer], cfg.rms_eps)
        ffn = moe_fn(params, cfg, layer, xn).to(x.dtype)
    x = fused_add_rmsnorm(ffn, x, params["final_norm"], cfg.rms_eps)[0]
    return (x @ params["lm_head"]).float(), (k_all, v_all)
