"""Sketch generation & response-length awareness (paper §III / §IV-A-2).

Prompt templates follow the paper's progressive-inference engine. With the
byte-level testbed models the templates use compact markers the models are
trained on (data/corpus.py grammar):

    cloud sketch:     "Q: {query}\nS:"          -> sketch
    cloud full:       "Q: {query}\nA:"          -> full answer
    edge expansion:   "Q: {query}\nS: {sketch}\nE: {sentence}|" -> expansion

Length prediction: LLMs can perceive response length in advance (paper cites
[22]); we implement it as (a) the trained bucket head on the cloud model
(ModelConfig.length_buckets) and (b) a calibrated heuristic fallback.
"""
from __future__ import annotations

from typing import List

from repro_torch.data import tokenizer as tok
from repro_torch.data.corpus import SHORT_CATEGORIES

LENGTH_BUCKET_TOKENS = 64      # bucket b predicts ~ (b + 0.5) * 64 tokens


def cloud_full_prompt(query: str) -> str:
    return f"Q: {query}\nA:"


def cloud_sketch_prompt(query: str, max_sketch_tokens: int) -> str:
    # the token budget is enforced by max_new_tokens at generation time; the
    # paper notes |r_i| may differ from the requested level by ~10 tokens.
    return f"Q: {query}\nS:"


def edge_expand_prefix(query: str, sketch: str) -> str:
    """The (query, sketch) context every parallel expansion group repeats —
    with the byte-level tokenizer, encode(prefix) + encode(suffix) ==
    encode(prefix + suffix), so the serving engine can prefill this once and
    fan groups out over copy-on-write shared KV pages."""
    return f"Q: {query}\nS: {sketch}\nE: "


def edge_expand_suffix(sentences: List[str]) -> str:
    """The per-group tail of the expansion prompt (see edge_expand_prefix)."""
    sent = ". ".join(s.rstrip(".") for s in sentences)
    return f"{sent}|"


def edge_expand_prompt(query: str, sketch: str, sentences: List[str]) -> str:
    """The paper's §IV-B template, adapted to the testbed grammar; merged
    groups concatenate their sentences ('complete only this sentence')."""
    return edge_expand_prefix(query, sketch) + edge_expand_suffix(sentences)


def segment_sketch(sketch_text: str) -> List[str]:
    return tok.split_sentences(sketch_text)


def heuristic_expected_length(query: str, category: str = "generic") -> int:
    """Fallback length predictor (calibrated on the synthetic corpus)."""
    base = 40 if category in SHORT_CATEGORIES else 220
    return base + 6 * len(query.split())


def bucket_to_tokens(bucket: int) -> int:
    return int((bucket + 0.5) * LENGTH_BUCKET_TOKENS)


def tokens_to_bucket(n_tokens: int, n_buckets: int = 16) -> int:
    return min(max(n_tokens // LENGTH_BUCKET_TOKENS, 0), n_buckets - 1)
