"""Plain PyTorch versions of paged chunked-prefill attention:
gather-then-attend.

Materialize each row's block row into the contiguous layout (the chunk's
K/V already written), then run causal masked attention — the numerics
contract for the CUDA kernel, written as the JAX package's oracles
(`repro/kernels/paged_prefill_attention/ref.py`) are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention.ref import softmax_scale
from repro_torch.models import paged_cache as pc

NEG_INF = -1e30


def paged_prefill_attention_ragged_ref(q, k_pages, v_pages, block_rows,
                                       offsets, lens):
    """q: (R, C, Hq, hd) — row r is one slot's chunk queries (RoPE applied,
    chunk K/V already written); block_rows: (R, P) per-row block-table rows;
    offsets/lens: (R,). Returns (R, C, Hq, hd); row r positions past lens[r]
    are unspecified, as is every position of padding rows (lens[r] == 0)."""
    R, C, Hq, hd = q.shape
    rep = Hq // k_pages.shape[2]
    gk = pc.gather_sequence(k_pages, block_rows)         # (R, P*page, Hkv, hd)
    gv = pc.gather_sequence(v_pages, block_rows)
    S = gk.shape[1]
    k = gk.repeat_interleave(rep, dim=2) if rep > 1 else gk
    v = gv.repeat_interleave(rep, dim=2) if rep > 1 else gv
    qpos = offsets[:, None] + torch.arange(C, device=q.device)[None, :]
    kpos = torch.arange(S, device=q.device)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)     # (R,Hq,C,S)
    total = (offsets + lens)[:, None, None]
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < total))[:, None]        # (R,1,C,S)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_row, offset,
                                chunk_len):
    """One slot's chunk: q (1, C, Hq, hd); block_row (P,); offset/chunk_len
    (1,) int32 tensors. Returns (1, C, Hq, hd); rows past chunk_len are
    unspecified."""
    return paged_prefill_attention_ragged_ref(
        q, k_pages, v_pages, block_row[None], offset.reshape(1),
        chunk_len.reshape(1))
