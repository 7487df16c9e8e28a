"""Public wrapper for paged flash-decode attention.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/paged_decode_attention.cu`) or raises; a CPU tensor runs the plain
version (`ref.py`). `paged_decode_attention.launches` counts kernel
launches, and only those.
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
    zeros."""
    if not runtime.use_kernel(q, k_pages, v_pages, block_table, lengths):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               block_table, lengths)
    out = _kernel.paged_decode_attention_cuda(q, k_pages, v_pages,
                                              block_table, lengths)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
