"""Public wrappers for paged chunked-prefill attention.

`paged_prefill_attention_ragged` (R slots' chunks in one call, the engine's
batched ingest) and `paged_prefill_attention` (one slot's chunk, the shared
prefix prefill of a fan-out), and their `_quant` twins over an int8 / fp8
pool with per-(page, kv head) scales, each launch the hand-written kernel
of `csrc/paged_prefill_attention.cu` on a CUDA tensor — the single-slot
wrappers at R = 1 — or raise; on a CPU tensor each runs its plain version
(`ref.py`). Each wrapper counts its own kernel launches in `.launches`. A
float pool may store float32 or bfloat16 whatever q's type; outputs are in
q's type.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.paged_prefill_attention import kernel as _kernel
from repro_torch.kernels.paged_prefill_attention import ref as _ref


def paged_prefill_attention_ragged(q, k_pages, v_pages, block_rows, offsets,
                                   lens):
    """Batched ragged chunked-prefill GQA attention over a paged KV pool.

    q: (R, C, Hq, hd) — row r is one slot's next chunk queries (its chunk
    K/V already written); k/v_pages: (n_pages, page_size, Hkv, hd);
    block_rows: (R, P) int32 (-1 = unmapped), pre-trimmed to the shared
    live width; offsets/lens: (R,) int32. Row r positions past lens[r] are
    zeros, as are padding rows (lens == 0), on both routes."""
    if not runtime.use_kernel(q, k_pages, v_pages, block_rows, offsets,
                              lens):
        return _ref.paged_prefill_attention_ragged_ref(
            q, k_pages, v_pages, block_rows, offsets, lens)
    out = _kernel.paged_prefill_attention_cuda(q, k_pages, v_pages,
                                               block_rows, offsets, lens)
    paged_prefill_attention_ragged.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_row, offset,
                            chunk_len):
    """One slot's chunk: q (1, C, Hq, hd); block_row (P,) int32; offset /
    chunk_len: ints or (1,) int32 tensors on q's device. Rows past
    chunk_len are zeros."""
    offset = _scalar(offset, q.device)
    chunk_len = _scalar(chunk_len, q.device)
    if not runtime.use_kernel(q, k_pages, v_pages, block_row, offset,
                              chunk_len):
        return _ref.paged_prefill_attention_ref(q, k_pages, v_pages,
                                                block_row, offset, chunk_len)
    if q.shape[0] != 1 or block_row.dim() != 1:
        raise ValueError("the single-slot wrapper takes q (1, C, Hq, hd) "
                         "and a (P,) block row")
    out = _kernel.paged_prefill_attention_cuda(
        q, k_pages, v_pages, block_row.reshape(1, -1), offset, chunk_len)
    paged_prefill_attention.launches += 1
    return out


def paged_prefill_attention_ragged_quant(q, k_pages, v_pages, k_scales,
                                         v_scales, block_rows, offsets,
                                         lens):
    """`paged_prefill_attention_ragged` over an int8 / float8_e4m3fn pool:
    each page tile is dequantized with its (page, kv head) scale
    (k/v_scales: (n_pages, Hkv) f32) as it is loaded."""
    if not runtime.use_kernel(q, k_pages, v_pages, k_scales, v_scales,
                              block_rows, offsets, lens):
        return _ref.paged_prefill_attention_ragged_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_rows, offsets,
            lens)
    out = _kernel.paged_prefill_attention_cuda(
        q, k_pages, v_pages, block_rows, offsets, lens, k_scales, v_scales)
    paged_prefill_attention_ragged_quant.launches += 1
    return out


def paged_prefill_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                  block_row, offset, chunk_len):
    """`paged_prefill_attention` over an int8 / float8_e4m3fn pool (see
    `paged_prefill_attention_ragged_quant`)."""
    offset = _scalar(offset, q.device)
    chunk_len = _scalar(chunk_len, q.device)
    if not runtime.use_kernel(q, k_pages, v_pages, k_scales, v_scales,
                              block_row, offset, chunk_len):
        return _ref.paged_prefill_attention_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_row, offset,
            chunk_len)
    if q.shape[0] != 1 or block_row.dim() != 1:
        raise ValueError("the single-slot wrapper takes q (1, C, Hq, hd) "
                         "and a (P,) block row")
    out = _kernel.paged_prefill_attention_cuda(
        q, k_pages, v_pages, block_row.reshape(1, -1), offset, chunk_len,
        k_scales, v_scales)
    paged_prefill_attention_quant.launches += 1
    return out


def _scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(torch.int32)
    return runtime.int32_on([v], device)


paged_prefill_attention_ragged.launches = 0
paged_prefill_attention.launches = 0
paged_prefill_attention_ragged_quant.launches = 0
paged_prefill_attention_quant.launches = 0
