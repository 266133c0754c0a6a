"""Plain float32 forward pass of a Mistral / Llama decoder, the yardstick
that decides ``correct``.

Plain PyTorch only, with TF32 off: pre-norm RMSNorm, grouped-query attention
with rotary embeddings (Hugging Face's rotate-half form, theta from the
config), causal softmax, a SiLU-gated MLP, an untied head. It reads the
benchmark's own seeded weights (``serve_bench.weights``) one layer at a
time, upcast to float32, and works out positions and attention itself; it
takes nothing from the program but the tokens it judges. Work runs in
blocks of rows so that a few GB suffice for the largest configuration.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from serve_bench import weights as W
from serve_bench.model import ModelShape

ROW_BLOCK = 1024  # token rows a matmul block
Q_BLOCK = 512  # query rows an attention block
VOCAB_BLOCK = 16384  # head columns a block


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, heads, d] rotated by position (rotate-half pairs (j, j + d/2))."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _blocked_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[r: r + ROW_BLOCK] @ w
                      for r in range(0, x.shape[0], ROW_BLOCK)])


def _attention(q, k, v, group: int) -> torch.Tensor:
    """Causal attention of one sequence: q [n, hq, d], k / v [n, hkv, d]."""
    n, hq, d = q.shape
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [hq, n, d]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(n, device=q.device)
    for r in range(0, n, Q_BLOCK):
        qb = q[r: r + Q_BLOCK].transpose(0, 1)  # [hq, b, d]
        s = (qb @ k.transpose(1, 2)) / d ** 0.5  # [hq, b, n]
        rows = keys[r: r + Q_BLOCK]
        s = s.masked_fill(keys[None, None, :] > rows[None, :, None],
                          float("-inf"))
        out[r: r + Q_BLOCK] = (torch.softmax(s, -1) @ v).transpose(0, 1)
    return out


def logits(m: ModelShape, seed: int, seqs: Sequence[Sequence[int]],
           starts: Sequence[int], device: torch.device) -> List[torch.Tensor]:
    """For each token sequence, the f32 logits [len - start, vocab] of its
    positions start - 1 ... len - 2, each predicting the token after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(m, seed, seqs, starts, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@torch.no_grad()
def _logits(m, seed, seqs, starts, device):
    hq, hkv, d = m.q_heads, m.kv_heads, m.head_dim
    emb = W.draw(m, seed, "embedding", -1, device)
    toks = [torch.as_tensor(list(s), dtype=torch.long, device=device)
            for s in seqs]
    xs = [emb[t].float() for t in toks]
    del emb
    pos = [torch.arange(len(s), device=device) for s in seqs]
    for li in range(m.layers):
        lw = {k: v.float() for k, v in W.layer(m, seed, li, device).items()}
        for j, x in enumerate(xs):
            n = x.shape[0]
            qkv = _blocked_mm(_rmsnorm(x, lw["attn_norm"], m.rms_eps),
                              lw["wqkv"])
            q = qkv[:, : hq * d].reshape(n, hq, d)
            k = qkv[:, hq * d: (hq + hkv) * d].reshape(n, hkv, d)
            v = qkv[:, (hq + hkv) * d:].reshape(n, hkv, d)
            del qkv
            q = _rope(q, pos[j], m.rope_theta)
            k = _rope(k, pos[j], m.rope_theta)
            a = _attention(q, k, v, hq // hkv).reshape(n, hq * d)
            x = x + _blocked_mm(a, lw["wo"])
            del q, k, v, a
            xn = _rmsnorm(x, lw["mlp_norm"], m.rms_eps)
            for r in range(0, n, ROW_BLOCK):
                gu = xn[r: r + ROW_BLOCK] @ lw["w_gate_up"]
                g, u = gu[:, : m.intermediate], gu[:, m.intermediate:]
                x[r: r + ROW_BLOCK] += (torch.nn.functional.silu(g) * u
                                        ) @ lw["w_down"]
                del gu, g, u
            xs[j] = x
        del lw
    fnorm = W.draw(m, seed, "final_norm", -1, device).float()
    head = W.draw(m, seed, "lm_head", -1, device)
    out = []
    for x, s0 in zip(xs, starts):
        xn = _rmsnorm(x[s0 - 1: -1], fnorm, m.rms_eps)
        out.append(torch.cat([xn @ head[:, c: c + VOCAB_BLOCK].float()
                              for c in range(0, m.vocab, VOCAB_BLOCK)], 1))
    return out
