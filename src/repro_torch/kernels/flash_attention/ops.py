"""Public wrapper for full-sequence flash attention.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/flash_attention.cu`) or raises; a CPU tensor runs the plain version
(`ref.py`). `flash_attention.launches` counts kernel launches, and only
those.
"""
from __future__ import annotations

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Causal / sliding-window GQA attention with an optional tanh softcap.

    q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) with Hq % Hkv == 0. Returns
    (B,S,Hq,hd)."""
    if not runtime.use_kernel(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    out = _kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
