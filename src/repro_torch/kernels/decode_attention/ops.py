"""Public wrapper for flash-decode attention over a dense KV cache.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/decode_attention.cu`) or raises; a CPU tensor runs the plain version
(`ref.py`). `decode_attention.launches` counts kernel launches, and only
those.
"""
from __future__ import annotations

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref


def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token GQA attention over a (possibly ragged) dense KV cache.

    q: (B,1,Hq,hd); k/v_cache: (B,S,Hkv,hd); lengths: (B,) int32 valid
    cache rows. Rows past a slot's length carry no weight whatever they
    hold; a zero-length slot returns zeros."""
    if not runtime.use_kernel(q, k_cache, v_cache, lengths):
        return _ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    out = _kernel.decode_attention_cuda(q, k_cache, v_cache, lengths)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
