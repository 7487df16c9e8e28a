"""Plain PyTorch version of full-sequence GQA attention (causal or not,
sliding window, tanh softcap): the numerics contract for the CUDA kernel,
written as the JAX package's oracle (`repro/kernels/flash_attention/ref.py`
`mha_ref`) is."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention.ref import (NEG_INF,
                                                           softmax_scale)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    B, S, Hq, hd = q.shape
    rep = Hq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = ki <= qi
    if window:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)
