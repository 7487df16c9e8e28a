"""Token samplers: greedy / temperature / top-k / top-p (PyTorch).

Random draws come from an explicit `torch.Generator` (the engine keeps one
per engine, on its device). A caller may pass the Gumbel noise itself
instead: the JAX package samples `argmax(logits + gumbel)` too
(`jax.random.categorical`), so feeding both the same noise gives the same
tokens, which is how the tests compare them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0


def gumbel_noise(shape, generator: torch.Generator, device,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1). With `out` (a float32
    tensor of `shape`) the noise is drawn into it, the same draw bit for
    bit."""
    if out is None:
        e = torch.empty(shape, dtype=torch.float32, device=device)
        return -torch.log(e.exponential_(generator=generator))
    return out.exponential_(generator=generator).log_().neg_()


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 tokens. Non-greedy sampling draws its
    Gumbel noise from `generator` unless `noise` (B, V) is given."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / cfg.temperature
    if cfg.top_k:
        # clamp: top_k >= vocab means no truncation
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        # Rank-based nucleus: keep exactly the first k sorted tokens, where
        # k is the smallest count whose cumulative mass reaches top_p (a
        # value-based cutoff would keep every token tied with the boundary
        # logit). `flip` of the stable ascending argsort keeps masked -inf
        # entries ranked last, as the JAX package does.
        order = torch.flip(torch.argsort(logits, dim=-1, stable=True), (-1,))
        ranks = torch.argsort(order, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, order)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        k = torch.sum(cum < cfg.top_p, dim=-1) + 1
        logits = torch.where(ranks < k[:, None], logits, -torch.inf)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1)


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) under logits. logits: (B,V), tokens: (B,) -> (B,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, None].long())[:, 0]
