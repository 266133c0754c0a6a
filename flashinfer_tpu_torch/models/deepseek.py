"""DeepSeek-family model: MLA attention and a DeepSeek-V3-routed MoE FFN.

Counterpart of flashinfer_tpu/models/deepseek.py, with its structure: every
layer MoE (routed experts plus dense shared experts), sigmoid group-limited
routing, plain RoPE on the rope parts. Weights are a flat dict of tensors,
per-layer weights stacked on a leading [num_layers] axis, in the JAX
package's layouts (projections [in, out]; w13 [L, E, 2*inter, hidden] and
w2 [L, E, hidden, inter], read in place by the grouped GEMM).

Two paths:
  * ``deepseek_forward_dense``: the dense causal oracle (softmax attention
    over the compressed cache, no paging);
  * ``deepseek_decode_step``: one paged decode step over (ckv, kpe) caches
    through ``BatchMLAPagedAttentionWrapper`` (the MLA kernel) and
    ``append_paged_mla_kv_cache``; ``fused_moe`` runs the grouped-GEMM
    kernel, and every norm after the first adds the residual in the norm
    kernel's launch (``fused_add_rmsnorm``).

MLA (matrix-absorbed, DeepSeek-V2 section 2.1):
  c_kv = x W_dkv (cached), k_pe = RoPE(x W_kpe) (cached)
  score_h = (q_nope_h W_uk_h) . c_kv + RoPE(q_pe_h) . k_pe
  out_h = softmax(score) . c_kv, then W_uv_h and W_o project back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from flashinfer_tpu_torch.ops.activation import silu_and_mul
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
from flashinfer_tpu_torch.ops.page import append_paged_mla_kv_cache
from flashinfer_tpu_torch.ops.rope import (
    apply_rope_pos_ids,
    mla_rope_quantize_fp8,
)
from flashinfer_tpu_torch.utils import resolve_device, tensor_from_numpy

__all__ = [
    "DeepSeekConfig",
    "deepseek_init_weights",
    "deepseek_forward_dense",
    "deepseek_decode_step",
    "params_from_numpy",
]


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 4
    num_heads: int = 16
    head_dim_ckv: int = 512  # compressed KV (shared across heads; = V dim)
    head_dim_kpe: int = 64  # rope'd key part
    head_dim_qk_nope: int = 128  # per-head pre-absorption q/k dim
    num_experts: int = 8
    num_shared_experts: int = 1
    top_k: int = 2
    moe_inter_size: int = 1408
    n_group: int = 4
    topk_group: int = 2
    routed_scaling_factor: float = 1.0
    rope_theta: float = 1e4
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(dtype: torch.dtype = torch.float32) -> "DeepSeekConfig":
        return DeepSeekConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            head_dim_ckv=32, head_dim_kpe=16, head_dim_qk_nope=16,
            num_experts=4, num_shared_experts=1, top_k=2, moe_inter_size=32,
            n_group=2, topk_group=1, dtype=dtype)


def deepseek_init_weights(generator: torch.Generator, cfg: DeepSeekConfig,
                          device: str | torch.device = "cuda"
                          ) -> Dict[str, torch.Tensor]:
    """Random weights, normal scaled as the JAX package's (1/sqrt(hidden);
    1/sqrt(d_nope) for W_uk, 1/sqrt(d_ckv) for W_uv, 1 for the router),
    drawn directly in the model dtype on ``device`` from ``generator``
    (which must live on that device). Norm weights are ones."""
    device = resolve_device(device)
    h, L, nh = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    dc, dp, dn = cfg.head_dim_ckv, cfg.head_dim_kpe, cfg.head_dim_qk_nope
    e, i = cfg.num_experts, cfg.moe_inter_size
    s = 1.0 / math.sqrt(h)

    def rnd(shape, scale=s):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    return {
        "embedding": rnd((cfg.vocab_size, h)),
        "w_q": rnd((L, h, nh * (dn + dp))),
        "w_dkv": rnd((L, h, dc)),
        "w_kpe": rnd((L, h, dp)),
        "w_uk": rnd((L, nh, dn, dc), 1.0 / math.sqrt(dn)),
        "w_uv": rnd((L, nh, dc, dn), 1.0 / math.sqrt(dc)),
        "w_o": rnd((L, nh * dn, h)),
        "router": rnd((L, h, e), 1.0),
        "w13": rnd((L, e, 2 * i, h)),
        "w2": rnd((L, e, h, i)),
        "w13_shared": rnd((L, h, 2 * i * cfg.num_shared_experts)),
        "w2_shared": rnd((L, i * cfg.num_shared_experts, h)),
        "attn_norm": ones(L, h),
        "ffn_norm": ones(L, h),
        "final_norm": ones(h),
        "lm_head": rnd((h, cfg.vocab_size)),
    }


def params_from_numpy(np_params: Mapping[str, object],
                      device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's DeepSeek parameters (numpy arrays) as the port's
    tensors on ``device``, same names and layouts."""
    device = resolve_device(device)
    return {name: tensor_from_numpy(arr, device)
            for name, arr in np_params.items()}


def _mla_qkv(params, cfg, layer, xn, positions, rope: bool = True):
    """Absorbed q_nope [n, nh, dc], q_pe [n, nh, dp], c_kv [n, dc] and
    k_pe [n, dp], roped unless ``rope`` is False (the e4m3 path ropes in
    the fused mla_rope_quantize_fp8 prologue)."""
    n = xn.shape[0]
    nh, dn, dp = cfg.num_heads, cfg.head_dim_qk_nope, cfg.head_dim_kpe
    q = (xn @ params["w_q"][layer]).reshape(n, nh, dn + dp)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    c_kv = xn @ params["w_dkv"][layer]
    k_pe = xn @ params["w_kpe"][layer]
    q_abs = torch.einsum("nhd,hdc->nhc", q_nope,
                         params["w_uk"][layer]).to(xn.dtype)
    if not rope:
        return q_abs, q_pe, c_kv, k_pe
    q_pe, k_pe = apply_rope_pos_ids(q_pe, k_pe[:, None, :], positions,
                                    rope_theta=cfg.rope_theta)
    return q_abs, q_pe, c_kv, k_pe[:, 0]


def _moe_ffn(params, cfg, layer, xn):
    ids, scales = route_tokens(
        xn.float() @ params["router"][layer].float(), cfg.top_k,
        RoutingMethodType.DeepSeekV3, n_group=cfg.n_group,
        topk_group=cfg.topk_group,
        routed_scaling_factor=cfg.routed_scaling_factor)
    routed = fused_moe(xn, params["w13"][layer], params["w2"][layer], ids,
                       scales)
    shared = silu_and_mul(xn @ params["w13_shared"][layer]) @ \
        params["w2_shared"][layer]
    return routed + shared.to(routed.dtype)


def deepseek_forward_dense(params: Mapping[str, torch.Tensor],
                           token_ids: torch.Tensor,
                           cfg: DeepSeekConfig) -> torch.Tensor:
    """Dense causal forward, token_ids [batch, seq] -> logits [batch, seq,
    vocab] f32, with an explicit softmax over the compressed cache (the
    plain norm; the MoE runs ``fused_moe``)."""
    B, S = token_ids.shape
    x = params["embedding"][token_ids]
    pos = torch.arange(S, device=token_ids.device)
    sm_scale = 1.0 / math.sqrt(cfg.head_dim_qk_nope + cfg.head_dim_kpe)
    causal = pos[None, :] <= pos[:, None]  # [S(q), S(k)]
    for layer in range(cfg.num_layers):
        xn = rmsnorm_plain(x, params["attn_norm"][layer], cfg.rms_eps)
        parts = [_mla_qkv(params, cfg, layer, xn[b], pos) for b in range(B)]
        q_abs, q_pe, c_kv, k_pe = (torch.stack(t) for t in zip(*parts))
        s = (torch.einsum("bqhc,bkc->bhqk", q_abs.float(), c_kv.float())
             + torch.einsum("bqhp,bkp->bhqk", q_pe.float(), k_pe.float())
             ) * sm_scale
        s = torch.where(causal, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        attn_c = torch.einsum("bhqk,bkc->bqhc", p, c_kv.float())
        attn = torch.einsum("bqhc,hcd->bqhd", attn_c,
                            params["w_uv"][layer].float())
        attn = attn.reshape(B, S, -1).to(x.dtype)
        x = x + (attn @ params["w_o"][layer]).to(x.dtype)
        xn = rmsnorm_plain(x, params["ffn_norm"][layer], cfg.rms_eps)
        ffn = _moe_ffn(params, cfg, layer, xn.reshape(B * S, -1))
        x = x + ffn.reshape(B, S, -1).to(x.dtype)
    x = rmsnorm_plain(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"]).float()


def deepseek_decode_step(
    params: Mapping[str, torch.Tensor],
    cfg: DeepSeekConfig,
    token_ids: torch.Tensor,  # [batch]
    positions: torch.Tensor,  # [batch]
    ckv_caches: torch.Tensor,  # [L, pages, page_size, d_ckv]
    kpe_caches: torch.Tensor,  # [L, pages, page_size, d_kpe]
    kv_indices: torch.Tensor,
    kv_indptr: torch.Tensor,
    kv_last_page_len: torch.Tensor,
    mla_wrappers,  # planned BatchMLAPagedAttentionWrapper(s): one per layer,
    #                or one shared; the plan covers this step's batch
    *,
    kv_scale: float = 1.0,
    cos_sin_cache: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One paged decode step. Returns (logits [batch, vocab] f32, ckv_caches,
    kpe_caches); the new tokens' ckv and kpe are written into the caches in
    place (the JAX package returns new stacked caches instead).

    e4m3 serving: pass ``torch.float8_e4m3fn`` caches, the dequant
    ``kv_scale`` and a ``cos_sin_cache`` ([max_pos, d_kpe] f32,
    ``rope_cos_sin_cache``); the new tokens then take the fused
    ``mla_rope_quantize_fp8`` prologue and attention reads the e4m3 cache
    in the kernel."""
    fp8 = ckv_caches.dtype == torch.float8_e4m3fn
    if fp8 and cos_sin_cache is None:
        raise ValueError("e4m3 MLA decode needs a cos_sin_cache for the "
                         "fused rope + quantize prologue")
    B = token_ids.shape[0]
    x = params["embedding"][token_ids]
    batch_indices = torch.arange(B, dtype=torch.int32, device=x.device)
    ffn = None  # the sublayer output the next norm adds to x
    for layer in range(cfg.num_layers):
        w = (mla_wrappers[layer] if isinstance(mla_wrappers, (list, tuple))
             else mla_wrappers)
        xn, x = add_rmsnorm(ffn, x, params["attn_norm"][layer], cfg.rms_eps)
        if fp8:
            q_abs, q_pe_raw, c_kv, k_pe_raw = _mla_qkv(
                params, cfg, layer, xn, positions, rope=False)
            q_pe, k_pe, _, c_kv = mla_rope_quantize_fp8(
                q_pe_raw, k_pe_raw, q_abs, c_kv, cos_sin_cache, positions,
                quant_scale_kv=1.0 / kv_scale, quantize_q=False)
        else:
            q_abs, q_pe, c_kv, k_pe = _mla_qkv(params, cfg, layer, xn,
                                               positions)
        ckv_c, kpe_c = append_paged_mla_kv_cache(
            c_kv, k_pe, batch_indices, positions, ckv_caches[layer],
            kpe_caches[layer], kv_indices, kv_indptr, kv_last_page_len)
        attn_c = w.run(q_abs, q_pe, ckv_c, kpe_c, ckv_scale=kv_scale,
                       kpe_scale=kv_scale)
        attn = torch.einsum("nhc,hcd->nhd", attn_c.float(),
                            params["w_uv"][layer].float())
        attn = attn.reshape(B, -1).to(x.dtype)
        xn, x = fused_add_rmsnorm((attn @ params["w_o"][layer]).to(x.dtype),
                                  x, params["ffn_norm"][layer], cfg.rms_eps)
        ffn = _moe_ffn(params, cfg, layer, xn).to(x.dtype)
    x = fused_add_rmsnorm(ffn, x, params["final_norm"], cfg.rms_eps)[0]
    return (x @ params["lm_head"]).float(), ckv_caches, kpe_caches
