"""Synthetic structured corpus for the PICE testbed.

The corpus is a templated Q->A language in which answers are multi-sentence
and compressible: each answer sentence has a "key tokens" core (subject,
relation, object) plus deterministic filler — exactly the redundancy
phenomenon PICE exploits (Observation 1). A *sketch* of an answer keeps only
the key tokens; the full answer is recoverable from the sketch by re-applying
the filler grammar, so a model that has learned the grammar can expand
sketches faithfully (Observation 2).

This gives us measurable quality: expansion quality = token agreement between
the expanded answer and the ground-truth full answer.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple

SUBJECTS = ["the system", "a network", "the model", "an agent", "the server",
            "a device", "the cache", "an index", "the router", "a queue"]
RELATIONS = ["stores", "routes", "computes", "balances", "caches", "splits",
             "merges", "predicts", "encodes", "ranks"]
OBJECTS = ["tokens", "queries", "weights", "batches", "packets", "sketches",
           "layers", "answers", "tasks", "scores"]
FILL_PRE = "in practice "
FILL_MID = " carefully "
FILL_POST = " at scale for every user"

CATEGORIES = ["generic", "knowledge", "roleplay", "fermi", "coding", "math",
              "writing", "reasoning", "stem", "humanities", "common-sense",
              "counterfactual"]

# categories with inherently short answers (paper Fig. 7: low parallelism)
SHORT_CATEGORIES = {"math", "common-sense", "coding"}


@dataclasses.dataclass
class QAExample:
    query: str
    answer: str            # full answer (ground truth y)
    sketch: str            # gold compressed sketch r
    category: str
    answer_sentences: List[str]
    sketch_sentences: List[str]


def make_sentence(rng: random.Random) -> Tuple[str, str]:
    """Returns (full_sentence, sketch_sentence)."""
    s, r, o = rng.choice(SUBJECTS), rng.choice(RELATIONS), rng.choice(OBJECTS)
    sketch = f"{s} {r} {o}"
    full = f"{FILL_PRE}{s}{FILL_MID}{r} {o}{FILL_POST}"
    return full, sketch


def make_example(rng: random.Random, category: str = None) -> QAExample:
    category = category or rng.choice(CATEGORIES)
    n = rng.randint(1, 3) if category in SHORT_CATEGORIES else rng.randint(3, 8)
    fulls, sketches = [], []
    for _ in range(n):
        f, s = make_sentence(rng)
        fulls.append(f)
        sketches.append(s)
    topic = sketches[0]
    query = f"explain how {topic} works"
    return QAExample(
        query=query,
        answer=". ".join(fulls) + ".",
        sketch=". ".join(sketches) + ".",
        category=category,
        answer_sentences=fulls,
        sketch_sentences=sketches,
    )


def expand_sketch_sentence(sketch_sentence: str) -> str:
    """Ground-truth grammar expansion of one sketch sentence."""
    words = sketch_sentence.strip().rstrip(".").split()
    if len(words) < 3:
        return sketch_sentence
    o = words[-1]
    r = words[-2]
    s = " ".join(words[:-2])
    return f"{FILL_PRE}{s}{FILL_MID}{r} {o}{FILL_POST}"


def corpus(n: int, seed: int = 0, category: str = None) -> List[QAExample]:
    rng = random.Random(seed)
    return [make_example(rng, category) for _ in range(n)]


def lm_text(n: int, seed: int = 0, categories: List[str] = None,
            bias: float = 0.8) -> str:
    """Plain LM training text: Q/A transcripts (teaches the filler grammar).

    `categories` biases the mix toward those categories (prob `bias`) —
    used to give each edge SLM *diverse strengths* (paper §IV-C: SLMs are
    complementary due to variations in training data)."""
    rng = random.Random(seed)
    parts = []
    for i in range(n):
        cat = None
        if categories and rng.random() < bias:
            cat = rng.choice(categories)
        ex = make_example(rng, cat)
        parts.append(f"Q: {ex.query}\nA: {ex.answer}\n")
        # expansion transcripts teach the sketch->answer mapping
        if i % 3 == 0:
            parts.append(f"Q: {ex.query}\nS: {ex.sketch}\nE: "
                         f"{ex.sketch_sentences[0]}| {ex.answer_sentences[0]}\n")
    return "".join(parts)


def sketch_sft_pairs(n: int, seed: int = 0) -> List[Tuple[str, str]]:
    """(document, summary/sketch) pairs for §IV-D supervised fine-tuning."""
    return [(ex.answer, ex.sketch) for ex in corpus(n, seed)]
