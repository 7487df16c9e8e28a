"""Plain PyTorch version of flash-decode attention over a dense KV cache:
masked softmax over each slot's first `lengths[b]` cache rows — the
numerics contract for the CUDA kernel, written as the JAX package's oracle
(`repro/kernels/decode_attention/ref.py`) is, with the Pallas kernel's two
edge cases: rows past a length are zeroed before the products (whatever
they hold, NaN included, carries no weight) and a slot of length 0 returns
zeros (the oracle returns the mean of V there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention.ref import (NEG_INF,
                                                           softmax_scale)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: (B,1,Hq,hd); k/v_cache: (B,S,Hkv,hd); lengths: (B,) valid cache
    rows (values past S read all S). Returns (B,1,Hq,hd)."""
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])                              # (B, S)
    k = torch.where(valid[:, :, None, None], k_cache, 0)
    v = torch.where(valid[:, :, None, None], v_cache, 0)
    qg = q[:, 0].reshape(B, Hkv, rep, hd)
    logits = torch.einsum("bgrh,bkgh->bgrk", qg.float(),
                          k.float()) * softmax_scale(hd)       # (B,Hkv,rep,S)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgh->bgrh", probs.to(v.dtype), v)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, 1, Hq, hd)
