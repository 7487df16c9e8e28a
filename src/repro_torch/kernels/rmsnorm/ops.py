"""Public wrappers for the row RMSNorm and its backward.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/rmsnorm.cu`) or raises; a CPU tensor runs the plain version
(`ref.py`). `rmsnorm.launches` and `rmsnorm_bwd.launches` count kernel
launches, and only those.

Every norm of the port's models calls it through `models.layers.rmsnorm`
(norm1, norm2, the final norm, q_norm / k_norm, Mamba2's gated norm). The
JAX package's models normalise through plain jnp, which the plain version
repeats step for step. On a CUDA tensor that needs a gradient the forward
is a `torch.autograd.Function` whose backward is the backward kernel; on
the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.rmsnorm import kernel as _kernel
from repro_torch.kernels.rmsnorm import ref as _ref


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        out = _kernel.rmsnorm_cuda(x, scale, eps)
        rmsnorm.launches += 1
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,). The mean of squares in float32, the output
    in x's dtype."""
    if not runtime.use_kernel(x, scale):
        return _ref.rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    out = _kernel.rmsnorm_cuda(x, scale, eps)
    rmsnorm.launches += 1
    return out


def rmsnorm_bwd(x, scale, g, eps: float = 1e-6):
    """The backward of `rmsnorm` at x for the output gradient g (x's shape
    and dtype). -> (dx in x's dtype, dscale (D,) float32)."""
    if not runtime.use_kernel(x, scale, g):
        return _ref.rmsnorm_bwd_ref(x, scale, g, eps)
    out = _kernel.rmsnorm_bwd_cuda(x, scale, g, eps)
    rmsnorm_bwd.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
