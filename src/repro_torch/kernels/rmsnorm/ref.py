"""Plain PyTorch version of the row RMSNorm, written as the JAX package's
oracle (`repro/kernels/rmsnorm/ref.py`) is: the mean of squares in float32,
the output in x's dtype."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
