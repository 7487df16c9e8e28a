"""Public wrappers for full-sequence flash attention and its backward.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/flash_attention.cu`) or raises; a CPU tensor runs the plain version
(`ref.py`). `flash_attention.launches` and `flash_attention_bwd.launches`
count kernel launches, and only those. On CUDA tensors that need a
gradient the forward is a `torch.autograd.Function`: the kernel also
writes each row's log-sum-exp, and the backward is the backward kernel; on
the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _kernel.flash_attention_cuda(
            q, k, v, causal=causal, window=window, softcap=softcap,
            with_lse=True)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=causal, window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Causal / sliding-window GQA attention with an optional tanh softcap.

    q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) with Hq % Hkv == 0. Returns
    (B,S,Hq,hd)."""
    if not runtime.use_kernel(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, window, softcap)
    out = _kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The backward of `flash_attention` from its output o, the rows'
    log-sum-exp lse (B,Hq,S) and the output gradient do. -> (dq, dk, dv)."""
    if not runtime.use_kernel(q, k, v, o, lse, do):
        return _ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            softcap=softcap)
    out = _kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           softcap=softcap)
    flash_attention_bwd.launches += 1
    return out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
