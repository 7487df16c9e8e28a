"""Training data pipeline: tokenization, packing, batching.

A copy of the JAX package's `data/pipeline.py` (numpy only): deterministic,
host-side, and from one seed the same batches array for array. The train
loop moves each batch to the device once.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclasses.dataclass
class PackedDataset:
    """Pack a token stream into (B, S+1) rows; yields (tokens, targets)."""
    text: str
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        ids = np.asarray(tok.encode(self.text), np.int32)
        row = self.seq_len + 1
        n_rows = len(ids) // row
        if n_rows == 0:
            reps = row // max(len(ids), 1) + 1
            ids = np.tile(ids, reps)
            n_rows = len(ids) // row
        self.rows = ids[: n_rows * row].reshape(n_rows, row)
        self.rng = np.random.default_rng(self.seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            idx = self.rng.integers(0, len(self.rows), self.batch_size)
            chunk = self.rows[idx]
            yield chunk[:, :-1], chunk[:, 1:]


def seq2seq_batch(pairs: List[Tuple[str, str]], seq_len: int,
                  rng: np.random.Generator,
                  batch_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input -> output) examples packed as 'IN <sep> OUT' with loss mask on OUT.

    Returns (tokens, targets, mask) of shape (B, seq_len).
    """
    B = batch_size
    tokens = np.zeros((B, seq_len + 1), np.int32)
    mask = np.zeros((B, seq_len), np.float32)
    idx = rng.integers(0, len(pairs), B)
    for b, i in enumerate(idx):
        src, dst = pairs[i]
        ids = tok.encode(src)[: seq_len // 2] + [ord("|")] + tok.encode(dst)
        ids = ids[: seq_len] + [tok.EOS]
        tokens[b, : len(ids)] = ids
        out_start = min(len(tok.encode(src)[: seq_len // 2]) + 1, seq_len)
        mask[b, out_start - 1: len(ids) - 1] = 1.0
    return tokens[:, :-1], tokens[:, 1:], mask
