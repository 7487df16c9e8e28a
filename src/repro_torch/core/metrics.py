"""Text-similarity metrics: ROUGE-1 / ROUGE-L (pure python, no deps)."""
from __future__ import annotations

from collections import Counter
from typing import List, Tuple


def _tokens(text: str) -> List[str]:
    return text.lower().replace(".", " ").replace(",", " ").split()


def rouge_1(reference: str, candidate: str) -> Tuple[float, float, float]:
    """Unigram (precision, recall, f1) of candidate against reference."""
    ref, cand = Counter(_tokens(reference)), Counter(_tokens(candidate))
    if not ref or not cand:
        return 0.0, 0.0, 0.0
    overlap = sum((ref & cand).values())
    p = overlap / max(sum(cand.values()), 1)
    r = overlap / max(sum(ref.values()), 1)
    f1 = 0.0 if (p + r) == 0 else 2 * p * r / (p + r)
    return p, r, f1


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(reference: str, candidate: str) -> Tuple[float, float, float]:
    """LCS-based (precision, recall, f1)."""
    ra, ca = _tokens(reference), _tokens(candidate)
    if not ra or not ca:
        return 0.0, 0.0, 0.0
    lcs = _lcs_len(ra, ca)
    p, r = lcs / len(ca), lcs / len(ra)
    f1 = 0.0 if (p + r) == 0 else 2 * p * r / (p + r)
    return p, r, f1


def token_agreement(reference: str, candidate: str) -> float:
    """Position-aligned word agreement (quality proxy for grammar expansion)."""
    ra, ca = _tokens(reference), _tokens(candidate)
    if not ra:
        return 0.0
    n = sum(1 for x, y in zip(ra, ca) if x == y)
    return n / max(len(ra), len(ca))
