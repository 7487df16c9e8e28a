"""Training losses (the JAX package's `training/losses.py` in PyTorch)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

# When > 0, cross_entropy processes the sequence in blocks of this many
# positions, so the float32 upcast of the logits is never materialized at
# (B, S, V) at once (the JAX package's memory-term option for large-vocab
# training).
CHUNKED_CE_BLOCK = 0


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """logits: (B,S,V) -> mean NLL over unmasked positions.

    Returns (loss, n_tokens). Computed in float32 with logsumexp stability.
    """
    S = logits.shape[1]
    blk = CHUNKED_CE_BLOCK
    if blk and S > blk and S % blk == 0:
        nll = torch.cat([_ce_terms(logits[:, i:i + blk], targets[:, i:i + blk])
                         for i in range(0, S, blk)], dim=1)
    else:
        nll = _ce_terms(logits, targets)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, targets: torch.Tensor,
            aux: torch.Tensor, mask: Optional[torch.Tensor] = None,
            prefix_len: int = 0):
    """Causal LM loss; drops `prefix_len` leading positions (VLM patch stub)."""
    if prefix_len:
        logits = logits[:, prefix_len:]
    loss, n = cross_entropy(logits, targets, mask)
    total = loss + cfg.router_aux_coef * aux
    return total, {"nll": loss, "aux": aux, "tokens": n,
                   "perplexity": torch.exp(loss)}
