"""Preference labeling for sketch quality (paper §IV-D step 2).

Given input x, the SFT model produces a full answer y and a pair of sketches
(r1, r2). Each sketch is scored:

    score(r) = beta1 * (1 / l_r) + beta2 * Rouge-L(y_hat, y)

where y_hat is the base model's expansion of r back into a full answer —
shorter sketches that still reconstruct the answer win. The higher-scoring
sketch becomes r_w, the other r_l, forming the triplet dataset D={(x,r_w,r_l)}.
Pure Python: a copy of the JAX package's `finetune/preference.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.metrics import rouge_l


@dataclasses.dataclass
class PreferenceTriple:
    x: str
    r_w: str
    r_l: str
    score_w: float
    score_l: float


def sketch_score(sketch: str, expanded: str, reference: str,
                 beta1: float = 8.0, beta2: float = 1.0) -> float:
    l_r = max(len(sketch.split()), 1)
    _, _, f1 = rouge_l(reference, expanded)
    return beta1 / l_r + beta2 * f1


def label_pair(x: str, y: str, r1: str, r2: str,
               expand_fn: Callable[[str, str], str],
               beta1: float = 8.0, beta2: float = 1.0) -> PreferenceTriple:
    """expand_fn(x, sketch) -> full answer reconstructed by the base LLM."""
    s1 = sketch_score(r1, expand_fn(x, r1), y, beta1, beta2)
    s2 = sketch_score(r2, expand_fn(x, r2), y, beta1, beta2)
    if s1 >= s2:
        return PreferenceTriple(x=x, r_w=r1, r_l=r2, score_w=s1, score_l=s2)
    return PreferenceTriple(x=x, r_w=r2, r_l=r1, score_w=s2, score_l=s1)
