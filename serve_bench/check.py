"""Whether what the timed window served is correct.

The engine samples (temperature 1, top-k, then top-p over the renormalised
top-k, as FlashInfer's ``top_k_first`` order). A served token is legal when
the reference's own filter keeps it. The number compared is the widest gap,
over the sampled requests' served tokens, by which a token's reference
logit lies below the lowest logit that the reference's filter keeps at that
position (0 where every token is kept): rounding in bf16 moves the filter's
edge by a little, a wrong logit moves a token far below it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def kept_floor(logits: torch.Tensor, top_k: int, top_p: float,
               temperature: float) -> torch.Tensor:
    """[n] the lowest logit of each row's top-k-then-top-p set."""
    vals, _ = torch.topk(logits, top_k, dim=-1)  # descending
    probs = torch.softmax(vals / temperature, dim=-1)
    before = torch.cumsum(probs, -1) - probs  # mass ranked above each
    keep = before < top_p
    last = keep.sum(-1) - 1
    return vals.gather(-1, last[:, None])[:, 0]


def gaps_below_kept(ref_logits: Sequence[torch.Tensor],
                    served: Sequence[Sequence[int]], top_k: int,
                    top_p: float, temperature: float) -> torch.Tensor:
    """Each served token's gap below the reference's kept set (negative
    where it is kept), all requests' tokens in one f32 CPU tensor."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(list(toks), dtype=torch.long, device=lg.device)
        floor = kept_floor(lg, top_k, top_p, temperature)
        out.append((floor - lg.gather(1, t[:, None])[:, 0]).float().cpu())
    return torch.cat(out) if out else torch.zeros(0)


def served_gap(ref_logits: Sequence[torch.Tensor],
               served: Sequence[Sequence[int]], top_k: int, top_p: float,
               temperature: float) -> float:
    """The widest gap below the reference's kept set, over every served
    token (0.0 when all are kept)."""
    g = gaps_below_kept(ref_logits, served, top_k, top_p, temperature)
    return max(0.0, float(g.max())) if g.numel() else 0.0


def pick_sample(requests, seed: int, min_tokens: int,
                max_requests: int) -> List[int]:
    """Indices of the requests to compare, among the finished ones (or,
    where none finished, as in a closed batch, those that were served):
    the one with the longest context (prompt and served tokens), then
    others drawn from the seed until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    done = ([i for i, r in enumerate(requests) if r.done]
            or [i for i, r in enumerate(requests) if r.output])
    if not done:
        return []
    longest = max(done, key=lambda i: len(requests[i].prompt)
                  + len(requests[i].output))
    rest = [i for i in done if i != longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    pick, tokens = [longest], len(requests[longest].output)
    for j in order:
        if tokens >= min_tokens or len(pick) >= max_requests:
            break
        pick.append(rest[j])
        tokens += len(requests[rest[j]].output)
    return pick


def format_checks(checks: Dict[str, Tuple[float, float]]) -> List[str]:
    return [f"{name} {value!r} limit {limit!r} "
            f"{'ok' if value is not None and value <= limit else 'FAILED'}"
            for name, (value, limit) in checks.items()]
