"""Tensor-parallel paged decode of the Llama family over a mesh dimension.

Counterpart of ``flashinfer_tpu/parallel/tp_serving.py``: Megatron-style
head sharding for attention (each rank runs the paged kernel over its kv
heads against its own cache shard), column/row-sharded MLP, and
``allreduce_rmsnorm`` at the attention boundary, one all-reduce after the
MLP. One process a rank; the weights and caches it takes are its shards.

Usage::

    params_tp = shard_llama_params_tp(params, mesh, cfg)   # this rank's
    step = make_tp_decode_step(mesh, cfg)
    logits_local, k, v = step(params_tp, kc, vc, tokens, positions, valid,
                              kv_indices, kv_indptr, kv_last, dplan_local)

with the attention plan built for the LOCAL head counts (identical on every
rank: the plan depends only on the sequence lengths).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.models.llama import LlamaConfig
from flashinfer_tpu_torch.ops.activation import silu_and_mul
from flashinfer_tpu_torch.ops.attention.batch import run_device_plan
from flashinfer_tpu_torch.ops.norm import rmsnorm
from flashinfer_tpu_torch.ops.page import append_paged_kv_cache
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.parallel.collectives import (
    all_reduce,
    allreduce_rmsnorm,
)
from flashinfer_tpu_torch.parallel.mesh import axis_size, local_shard
from flashinfer_tpu_torch.utils import (
    TensorLayout,
    resolve_device,
    tensor_from_numpy,
)

__all__ = ["shard_llama_params_tp", "make_tp_decode_step", "tp_param_specs"]


def tp_param_specs(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Partition specs of Megatron-style TP over the "tp" mesh dimension
    (JAX's values).
    ``w_gate_up``'s applies to its [L, h, 2, inter] view, so each shard
    holds matching gate and up column blocks."""
    return {
        "embedding": (None, None),
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "w_gate_up": (None, None, None, "tp"),  # on [L, h, 2, i]
        "w_down": (None, "tp", None),
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
        "final_norm": (None,),
        "lm_head": (None, "tp"),
    }


def shard_llama_params_tp(params: Mapping[str, object],
                          mesh: Optional[DeviceMesh], cfg: LlamaConfig, *,
                          device: Optional[str | torch.device] = None
                          ) -> Dict[str, torch.Tensor]:
    """This rank's TP shard of the Llama weights (``tp_param_specs``).
    ``params`` holds the full weights, numpy arrays (the JAX package's, as
    ``params_from_numpy`` takes them: only the shard is uploaded, to
    ``device``, default "cuda") or tensors (the shard is a view where it
    can be, moved to ``device`` when one is given). ``w_gate_up`` comes
    back [L, h, 2 * inter / tp]: this rank's gate columns, then its up
    columns, so ``silu_and_mul`` splits it as the full one. A fused
    ``wqkv`` is split into wq / wk / wv first (kept whole on one rank)."""
    specs = tp_param_specs(cfg)
    # a fused wqkv is whole on one rank, and split into its parts on more
    specs["wqkv"] = (None, None, "tp")
    params = dict(params)
    if "wqkv" in params and axis_size(mesh, "tp") > 1:
        w = params.pop("wqkv")
        hq, hkv, d = cfg.num_qo_heads, cfg.num_kv_heads, cfg.head_dim
        params["wq"] = w[..., : hq * d]
        params["wk"] = w[..., hq * d: (hq + hkv) * d]
        params["wv"] = w[..., (hq + hkv) * d:]
    out = {}
    for name, w in params.items():
        if name not in specs:
            raise ValueError(f"no TP spec for weight {name!r} (8-bit "
                             "weights are not sharded)")
        if name == "w_gate_up":
            L, h, two_i = w.shape
            w = local_shard(w.reshape(L, h, 2, two_i // 2), specs[name],
                            mesh)
            w = w.reshape(L, h, -1)
        else:
            w = local_shard(w, specs[name], mesh)
        if isinstance(w, np.ndarray):
            w = tensor_from_numpy(w, resolve_device(device or "cuda"))
        elif device is not None:
            w = w.to(resolve_device(device))
        out[name] = w
    return out


def make_tp_decode_step(mesh: Optional[DeviceMesh], cfg: LlamaConfig, *,
                        kv_scale: float = 1.0, axis: str = "tp"):
    """The TP decode step over ``axis``.

    Returns step(params_tp, k_cache, v_cache, tokens, positions, valid,
    kv_indices, kv_indptr, kv_last, dplan_local) -> (logits [B, vocab / tp]
    f32: this rank's vocabulary shard, k_cache, v_cache). ``params_tp`` is
    ``shard_llama_params_tp``'s; the caches are this rank's NHD [L, pages,
    page_size, kvh / tp, d] (dimension 3 over ``axis``), written in place
    (JAX donates them) and returned; tokens, positions, valid and the page
    table are replicated; ``dplan_local`` is a plan of the local head
    counts. With ``kv_scale`` != 1 the caches hold K / kv_scale, V /
    kv_scale in their dtype."""
    tp = axis_size(mesh, axis)
    if cfg.num_kv_heads % tp or cfg.num_qo_heads % tp:
        raise ValueError(f"{cfg.num_qo_heads}/{cfg.num_kv_heads} heads do "
                         f"not split over {tp} ranks")
    hq_l, hkv_l = cfg.num_qo_heads // tp, cfg.num_kv_heads // tp
    d = cfg.head_dim

    def step(params, k_cache, v_cache, tokens, positions, valid, kv_indices,
             kv_indptr, kv_last, dplan):
        B = tokens.shape[0]
        x = params["embedding"][tokens]
        batch_indices = torch.arange(B, dtype=torch.int32,
                                     device=tokens.device)
        for layer in range(cfg.num_layers):
            xn = rmsnorm(x, params["attn_norm"][layer], cfg.rms_eps)
            q = (xn @ params["wq"][layer]).reshape(B, hq_l, d)
            k = (xn @ params["wk"][layer]).reshape(B, hkv_l, d)
            v = (xn @ params["wv"][layer]).reshape(B, hkv_l, d)
            q, k = apply_rope_pos_ids(q, k, positions,
                                      rope_theta=cfg.rope_theta)
            if kv_scale != 1.0:
                k = (k.float() / kv_scale).to(k_cache.dtype)
                v = (v.float() / kv_scale).to(v_cache.dtype)
            kc, vc = k_cache[layer], v_cache[layer]
            append_paged_kv_cache(k.to(kc.dtype), v.to(vc.dtype),
                                  batch_indices, positions, (kc, vc),
                                  kv_indices, kv_indptr, kv_last,
                                  kv_layout="NHD", valid=valid)
            attn = run_device_plan(dplan, q, kc, vc,
                                   kv_layout=TensorLayout.NHD,
                                   k_scale=kv_scale, v_scale=kv_scale)
            # the row-parallel projection's partial, reduced in f32 into the
            # residual add and the norm
            part = attn.reshape(B, hq_l * d) @ params["wo"][layer]
            xn2, x = allreduce_rmsnorm(part.float(), x,
                                       params["mlp_norm"][layer],
                                       cfg.rms_eps, axis_name=axis,
                                       mesh=mesh)
            mlp = (silu_and_mul(xn2 @ params["w_gate_up"][layer])
                   @ params["w_down"][layer])
            x = x + all_reduce(mlp.float(), axis, mesh=mesh).to(x.dtype)
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        return (x @ params["lm_head"]).float(), k_cache, v_cache

    return step
