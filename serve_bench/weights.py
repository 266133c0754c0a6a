"""Random model weights made from the run's seed, on the device, in bf16.

Each tensor is drawn from a generator seeded by (seed, tensor name, layer),
so the reference can remake any one layer without holding a second copy of
the model. Matmul weights are normal with std 1 / sqrt(hidden), stored
[in, out] (``x @ w``); norm weights are ones. The attention projection is
one [hidden, (q_heads + 2 kv_heads) * head_dim] tensor, its columns q, then
k, then v, each head's ``head_dim`` columns together; the MLP's
[hidden, 2 * intermediate] holds the gate, then the up projection.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from serve_bench.model import ModelShape

LAYER_MATS = ("wqkv", "wo", "w_gate_up", "w_down")
LAYER_NORMS = ("attn_norm", "mlp_norm")


def _generator(seed: int, name: str, layer: int,
               device: torch.device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def mat_shape(m: ModelShape, name: str):
    h, i, d = m.hidden, m.intermediate, m.head_dim
    return {"wqkv": (h, (m.q_heads + 2 * m.kv_heads) * d),
            "wo": (m.q_heads * d, h),
            "w_gate_up": (h, 2 * i),
            "w_down": (i, h),
            "embedding": (m.vocab, h),
            "lm_head": (h, m.vocab)}[name]


def draw(m: ModelShape, seed: int, name: str, layer: int,
         device: torch.device, out: torch.Tensor = None) -> torch.Tensor:
    """Tensor ``name`` of ``layer`` (-1: a tensor outside the layers), in
    bf16; written into ``out`` when given."""
    if name in LAYER_NORMS or name == "final_norm":
        t = out if out is not None else torch.empty(
            m.hidden, dtype=torch.bfloat16, device=device)
        return t.fill_(1.0)
    shape = mat_shape(m, name)
    t = out if out is not None else torch.empty(
        shape, dtype=torch.bfloat16, device=device)
    return t.normal_(0.0, 1.0 / math.sqrt(m.hidden),
                     generator=_generator(seed, name, layer, device))


def layer(m: ModelShape, seed: int, index: int,
          device: torch.device) -> Dict[str, torch.Tensor]:
    return {n: draw(m, seed, n, index, device)
            for n in LAYER_MATS + LAYER_NORMS}


def fill_params(m: ModelShape, seed: int, device: torch.device,
                params: Dict[str, torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Every weight, the layer tensors stacked on a leading layer axis (the
    serving engine's layout). With ``params`` given, draws into its
    tensors in place (a new seed for the same engine)."""
    if params is None:
        params = {n: torch.empty((m.layers,) + (
            (m.hidden,) if n in LAYER_NORMS else mat_shape(m, n)),
            dtype=torch.bfloat16, device=device)
            for n in LAYER_MATS + LAYER_NORMS}
        params.update({n: torch.empty(mat_shape(m, n), dtype=torch.bfloat16,
                                      device=device)
                       for n in ("embedding", "lm_head")})
        params["final_norm"] = torch.empty(m.hidden, dtype=torch.bfloat16,
                                           device=device)
    for n in LAYER_MATS + LAYER_NORMS:
        for i in range(m.layers):
            draw(m, seed, n, i, device, out=params[n][i])
    for n in ("embedding", "lm_head", "final_norm"):
        draw(m, seed, n, -1, device, out=params[n])
    return params
