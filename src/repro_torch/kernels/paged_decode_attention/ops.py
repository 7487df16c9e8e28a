"""Public wrappers for paged flash-decode attention, over a float pool
(`paged_decode_attention`) and over an int8 / fp8 pool with per-(page, kv
head) scales (`paged_decode_attention_quant`).

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/paged_decode_attention.cu`, one kernel for both wrappers) or raises;
a CPU tensor runs the plain version (`ref.py`). Each wrapper's `.launches`
counts its own kernel launches, and only those.
"""
from __future__ import annotations

from repro_torch.kernels import runtime
from repro_torch.kernels.paged_decode_attention import kernel as _kernel
from repro_torch.kernels.paged_decode_attention import ref as _ref


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths):
    """Single-token GQA attention over a paged KV pool, read through the
    block table.

    q: (B,1,Hq,hd); k/v_pages: (n_pages, page_size, Hkv, hd);
    block_table: (B, P) int32 page ids (-1 = unmapped); lengths: (B,)
    int32 valid token counts. Pre-trim `block_table` to the live width so
    the read does not walk columns no slot uses. Zero-length rows return
    zeros. The pool may store float32 or bfloat16 whatever q's type (the
    products run in f32); the output is in q's type."""
    if not runtime.use_kernel(q, k_pages, v_pages, block_table, lengths):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               block_table, lengths)
    out = _kernel.paged_decode_attention_cuda(q, k_pages, v_pages,
                                              block_table, lengths)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_table, lengths):
    """`paged_decode_attention` over an int8 / float8_e4m3fn pool: pages are
    read at the storage width and dequantized with their per-(page, kv
    head) scales (k/v_scales: (n_pages, Hkv) f32). The output is in q's
    type."""
    if not runtime.use_kernel(q, k_pages, v_pages, k_scales, v_scales,
                              block_table, lengths):
        return _ref.paged_decode_attention_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_table, lengths)
    out = _kernel.paged_decode_attention_cuda(q, k_pages, v_pages,
                                              block_table, lengths,
                                              k_scales, v_scales)
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention_quant.launches = 0
