"""A configuration file read into the shape the benchmark works with, and
the yardstick's arithmetic: the operations and bytes a step needs.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense bf16):
989 TFLOP/s and 3.35 TB/s of HBM. Counts take each input byte read once
and each output byte written once, and only the rows and keys that the
requests need: padding the program adds is not work.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2  # bytes


@dataclasses.dataclass(frozen=True)
class ModelShape:
    vocab: int
    hidden: int
    intermediate: int
    layers: int
    q_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    rms_eps: float

    @staticmethod
    def from_config(cfg: dict) -> "ModelShape":
        """From a Hugging Face ``config.json`` of a dense RMSNorm / GQA /
        RoPE / SiLU-gated decoder without biases and with an untied head
        (``head_dim`` defaults to hidden / heads, as in Hugging Face's
        Mistral and Llama). Refuses what the served path cannot compute."""
        if cfg.get("hidden_act", "silu") != "silu":
            raise ValueError("only a SiLU-gated MLP is served")
        if cfg.get("sliding_window") is not None:
            raise ValueError("a sliding window is not served")
        if cfg.get("tie_word_embeddings", False):
            raise ValueError("a tied head is not served")
        heads = cfg["num_attention_heads"]
        return ModelShape(
            vocab=cfg["vocab_size"], hidden=cfg["hidden_size"],
            intermediate=cfg["intermediate_size"],
            layers=cfg["num_hidden_layers"], q_heads=heads,
            kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
            rope_theta=float(cfg["rope_theta"]),
            rms_eps=float(cfg["rms_norm_eps"]))

    # ------------------------------------------------------------- counts

    @property
    def layer_weight_elems(self) -> int:
        h, i, d = self.hidden, self.intermediate, self.head_dim
        return (h * (self.q_heads + 2 * self.kv_heads) * d
                + self.q_heads * d * h + 3 * h * i)

    @property
    def head_weight_elems(self) -> int:
        return self.hidden * self.vocab

    @property
    def params(self) -> int:
        """Every weight: the layers, the embedding and the head."""
        return (self.layers * (self.layer_weight_elems + 2 * self.hidden)
                + 2 * self.hidden * self.vocab + self.hidden)

    def matmul_flops(self, rows: int, head_rows: int) -> float:
        """Operations of the projections and MLPs over ``rows`` tokens and
        of the head over ``head_rows`` of them."""
        return 2.0 * (rows * self.layers * self.layer_weight_elems
                      + head_rows * self.head_weight_elems)

    def weight_bytes(self) -> float:
        """The matmul weights of one step, each read once."""
        return BF16 * (self.layers * self.layer_weight_elems
                       + self.head_weight_elems)

    def attn_flops(self, pairs: float) -> float:
        """Operations of attention over ``pairs`` (query, key) pairs
        across the layers: q.k and p.v, two each a head and a dim."""
        return 4.0 * pairs * self.q_heads * self.head_dim * self.layers

    def kv_bytes(self, keys: float) -> float:
        """K and V of ``keys`` cached tokens across the layers."""
        return 2.0 * BF16 * keys * self.kv_heads * self.head_dim * self.layers

    def qo_bytes(self, rows: float) -> float:
        """q read and o written for ``rows`` tokens across the layers."""
        return 2.0 * BF16 * rows * self.q_heads * self.head_dim * self.layers

    def kv_bytes_per_token(self) -> float:
        return self.kv_bytes(1)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time on the chip: the larger of operations over the bf16
    peak and bytes over the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
