"""Ensemble learning (paper §IV-C): select the best SLM expansion by the
confidence score Eq. (3):

    con(y^) = a1 * 2^{(1/N) sum_i log2 p(w_i)}        (inverse perplexity)
            + a2 * Norm(|y^|)                          (length score)
            + (1 - a1 - a2) * Rouge-1(r, y^)           (sketch similarity)

The perplexity term uses the generating model's own token log-probs (no
reward model — the paper explicitly avoids that overhead). Norm(|y^|)
normalizes response length across the candidate set (longer, more detailed
expansions score higher). Rouge-1 recall measures how much of the sketch the
expansion preserves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

from repro_torch.core.metrics import rouge_1


@dataclasses.dataclass
class Candidate:
    text: str
    mean_log2_prob: float          # (1/N) sum log2 p(w_i)
    n_tokens: int
    model: str
    extra: dict = dataclasses.field(default_factory=dict)


def length_norm(n: int, candidates: Sequence[Candidate]) -> float:
    mx = max((c.n_tokens for c in candidates), default=1)
    return n / max(mx, 1)


def confidence(cand: Candidate, sketch: str, candidates: Sequence[Candidate],
               alpha1: float = 0.4, alpha2: float = 0.2) -> float:
    inv_ppl = 2.0 ** cand.mean_log2_prob            # in (0, 1]
    ln = length_norm(cand.n_tokens, candidates)
    _, r1_recall, _ = rouge_1(sketch, cand.text)
    return (alpha1 * inv_ppl + alpha2 * ln
            + (1.0 - alpha1 - alpha2) * r1_recall)


def select_best(candidates: List[Candidate], sketch: str,
                alpha1: float = 0.4, alpha2: float = 0.2
                ) -> tuple[Candidate, List[float]]:
    assert candidates, "ensemble needs at least one candidate"
    scores = [confidence(c, sketch, candidates, alpha1, alpha2)
              for c in candidates]
    best = max(range(len(scores)), key=lambda i: scores[i])
    return candidates[best], scores


def mean_log2_from_nats(logprobs_nats: Sequence[float]) -> float:
    if not len(logprobs_nats):
        return -30.0
    mean_nats = sum(logprobs_nats) / len(logprobs_nats)
    return mean_nats / math.log(2.0)
