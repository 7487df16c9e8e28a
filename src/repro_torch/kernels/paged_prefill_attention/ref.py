"""Plain PyTorch versions of paged chunked-prefill attention:
gather-then-attend.

Materialize each row's block row into the contiguous layout (the chunk's
K/V already written; a quantized pool dequantized per (page, kv head) on
the way), then run causal masked attention — the numerics contract for the
CUDA kernel, written as the JAX package's oracles
(`repro/kernels/paged_prefill_attention/ref.py`) are. Keys at or past a
row's offset + len are zeroed before the products, as the kernels never
load them, and query rows past a row's len come out as zeros, as the
kernels write them. (The JAX package leaves those rows unspecified; a MoE
layer routes them, and their values decide which later tokens of the call
fit an expert's capacity, so the card and the CPU must agree on them.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention.ref import softmax_scale
from repro_torch.models import paged_cache as pc

NEG_INF = -1e30


def _attend_chunks(q, gk, gv, offsets, lens):
    """q: (R, C, Hq, hd); gk/gv: (R, S, Hkv, hd) gathered rows. Products in
    float32; with a pool type other than q's, the weighted sum runs in the
    wider of the two and the output is in q's type."""
    R, C, Hq, hd = q.shape
    rep = Hq // gk.shape[2]
    S = gk.shape[1]
    kpos = torch.arange(S, device=q.device)
    total = offsets + lens
    live = (kpos[None, :] < total[:, None])[:, :, None, None]   # (R,S,1,1)
    gk = torch.where(live, gk, torch.zeros_like(gk))
    gv = torch.where(live, gv, torch.zeros_like(gv))
    k = gk.repeat_interleave(rep, dim=2) if rep > 1 else gk
    v = gv.repeat_interleave(rep, dim=2) if rep > 1 else gv
    qpos = offsets[:, None] + torch.arange(C, device=q.device)[None, :]
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)     # (R,Hq,C,S)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < total[:, None, None]))[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    dt = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("bnqk,bknh->bqnh", probs.to(dt), v.to(dt))
    dead = (torch.arange(C, device=q.device)[None, :]
            >= lens[:, None])[:, :, None, None]
    return torch.where(dead, torch.zeros((), dtype=dt, device=q.device),
                       out).to(q.dtype)


def paged_prefill_attention_ragged_ref(q, k_pages, v_pages, block_rows,
                                       offsets, lens):
    """q: (R, C, Hq, hd) — row r is one slot's chunk queries (RoPE applied,
    chunk K/V already written); block_rows: (R, P) per-row block-table rows;
    offsets/lens: (R,). Returns (R, C, Hq, hd); row r positions past lens[r]
    are zeros, as is every position of padding rows (lens[r] == 0)."""
    return _attend_chunks(q, pc.gather_sequence(k_pages, block_rows),
                          pc.gather_sequence(v_pages, block_rows), offsets,
                          lens)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_row, offset,
                                chunk_len):
    """One slot's chunk: q (1, C, Hq, hd); block_row (P,); offset/chunk_len
    (1,) int32 tensors. Returns (1, C, Hq, hd); rows past chunk_len are
    zeros."""
    return paged_prefill_attention_ragged_ref(
        q, k_pages, v_pages, block_row[None], offset.reshape(1),
        chunk_len.reshape(1))


def paged_prefill_attention_ragged_quant_ref(q, k_pages, v_pages, k_scales,
                                             v_scales, block_rows, offsets,
                                             lens):
    """`paged_prefill_attention_ragged_ref` over an int8 / fp8 pool:
    dequantize-gather with the (n_pages, Hkv) f32 scales, then attend in
    f32."""
    return _attend_chunks(
        q, pc.gather_sequence_dequant(k_pages, k_scales, block_rows),
        pc.gather_sequence_dequant(v_pages, v_scales, block_rows), offsets,
        lens)


def paged_prefill_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                      v_scales, block_row, offset,
                                      chunk_len):
    """One slot's chunk over an int8 / fp8 pool (see
    `paged_prefill_attention_ref`)."""
    return paged_prefill_attention_ragged_quant_ref(
        q, k_pages, v_pages, k_scales, v_scales, block_row[None],
        offset.reshape(1), chunk_len.reshape(1))
