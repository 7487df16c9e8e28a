"""Plain PyTorch versions of paged decode attention: gather-then-attend.

Materialize each slot's block table into the contiguous layout (a quantized
pool dequantized per (page, kv head) on the way), then run masked attention
— the numerics contract for the CUDA kernel, written as the JAX package's
oracles (`repro/kernels/paged_decode_attention/ref.py`) are. Rows at or
past a slot's length are zeroed before the products, as the Pallas kernels
zero them, so whatever bytes lie there (NaN included) never reach the
output.
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


def _attend(q, gk, gv, lengths):
    """q: (B,1,Hq,hd); gk/gv: (B, S, Hkv, hd) gathered rows; lengths (B,).
    Products in float32; with a pool type other than q's, the weighted sum
    runs in the wider of the two and the output is in q's type."""
    B, _, Hq, hd = q.shape
    rep = Hq // gk.shape[2]
    S = gk.shape[1]
    kpos = torch.arange(S, device=q.device)
    live = kpos[None, :] < lengths[:, None]                     # (B, S)
    gk = torch.where(live[:, :, None, None], gk, torch.zeros_like(gk))
    gv = torch.where(live[:, :, None, None], gv, torch.zeros_like(gv))
    k = gk.repeat_interleave(rep, dim=2) if rep > 1 else gk
    v = gv.repeat_interleave(rep, dim=2) if rep > 1 else gv
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)     # (B,Hq,1,S)
    logits = torch.where(live[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    dt = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("bnqk,bknh->bqnh", probs.to(dt), v.to(dt))
    return torch.where((lengths > 0)[:, None, None, None], out,
                       torch.zeros_like(out)).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, lengths):
    """q: (B,1,Hq,hd); k/v_pages: (n_pages, page, Hkv, hd); block_table:
    (B, P) int32 (-1 = unmapped); lengths: (B,) valid token counts.
    Returns (B,1,Hq,hd) in q's dtype; zero-length rows return zeros."""
    return _attend(q, pc.gather_sequence(k_pages, block_table),
                   pc.gather_sequence(v_pages, block_table), lengths)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                                     block_table, lengths):
    """`paged_decode_attention_ref` over an int8 / fp8 pool: dequantize-
    gather with the (n_pages, Hkv) f32 scales, then attend in f32."""
    return _attend(q,
                   pc.gather_sequence_dequant(k_pages, k_scales, block_table),
                   pc.gather_sequence_dequant(v_pages, v_scales, block_table),
                   lengths)
