"""Byte-level tokenizer (vocab 256) with reserved control tokens.

Token 0 is EOS/pad. Printable ASCII round-trips; sentences are delimited by
'.' and newline, which is what the PICE sketch segmentation keys on.
"""
from __future__ import annotations

from typing import List

EOS = 0
VOCAB_SIZE = 256
SENTENCE_DELims = (ord("."), ord("\n"), ord(";"))


def encode(text: str) -> List[int]:
    return [b if b != EOS else ord(" ") for b in text.encode("utf-8", "replace")]


def decode(tokens: List[int]) -> str:
    out = bytes(t for t in tokens if 0 < t < 256)
    return out.decode("utf-8", "replace")


def split_sentences(text: str) -> List[str]:
    """Split a sketch into semantically-complete short sentences."""
    parts: List[str] = []
    cur = []
    for ch in text:
        cur.append(ch)
        if ch in ".;\n":
            s = "".join(cur).strip()
            if s and s not in (".", ";"):
                parts.append(s)
            cur = []
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    return parts
