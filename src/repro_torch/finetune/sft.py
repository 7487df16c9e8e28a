"""Supervised fine-tuning (paper §IV-D step 1): teach the LLM to emit concise
sketches. Data: (document -> sketch) pairs from the corpus, packed as
'A <sep> S' with loss only on the sketch tokens (`pipeline.seq2seq_batch`,
`train(masked=True)`)."""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.data import corpus as corpus_lib
from repro_torch.data import pipeline
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import TrainState, init_train_state, train


def sft_batches(pairs: List[Tuple[str, str]], seq_len: int, batch: int,
                seed: int = 0) -> Iterator:
    rng = np.random.default_rng(seed)
    while True:
        yield pipeline.seq2seq_batch(pairs, seq_len, rng, batch)


def run_sft(cfg: ModelConfig, n_steps: int = 200, seq_len: int = 192,
            batch: int = 8, n_pairs: int = 2000, seed: int = 0,
            state: TrainState = None, lr: float = 1e-3,
            log_fn=print, device=None) -> TrainState:
    """`n_steps` of masked AdamW from `state` (default: float32 masters
    from `seed` on `device`, the card unless the caller names another)."""
    pairs = corpus_lib.sketch_sft_pairs(n_pairs, seed)
    state = state or init_train_state(cfg, seed, device=device)
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=20, total_steps=n_steps)
    return train(cfg, state, sft_batches(pairs, seq_len, batch, seed),
                 opt_cfg, n_steps, masked=True, log_fn=log_fn)
