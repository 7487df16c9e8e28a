"""Plain PyTorch version of paged decode attention: gather-then-attend.

Materialize each slot's block table into the contiguous layout, then run
masked attention — the numerics contract for the CUDA kernel, written as the
JAX package's oracle (`repro/kernels/paged_decode_attention/ref.py`) is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import paged_cache as pc

NEG_INF = -1e30


def softmax_scale(hd: int) -> float:
    """1/sqrt(hd) rounded as float32 arithmetic rounds it (the kernels and
    the JAX package compute it in float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, lengths):
    """q: (B,1,Hq,hd); k/v_pages: (n_pages, page, Hkv, hd); block_table:
    (B, P) int32 (-1 = unmapped); lengths: (B,) valid token counts.
    Returns (B,1,Hq,hd); zero-length rows return zeros."""
    B, _, Hq, hd = q.shape
    rep = Hq // k_pages.shape[2]
    gk = pc.gather_sequence(k_pages, block_table)     # (B, P*page, Hkv, hd)
    gv = pc.gather_sequence(v_pages, block_table)
    S = gk.shape[1]
    k = gk.repeat_interleave(rep, dim=2) if rep > 1 else gk
    v = gv.repeat_interleave(rep, dim=2) if rep > 1 else gv
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)     # (B,Hq,1,S)
    kpos = torch.arange(S, device=q.device)
    mask = (kpos[None, :] < lengths[:, None])[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)
    return torch.where((lengths > 0)[:, None, None, None], out,
                       torch.zeros_like(out))
