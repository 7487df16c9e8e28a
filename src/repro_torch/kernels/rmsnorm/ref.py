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


def rmsnorm_bwd_ref(x, scale, g, eps: float = 1e-6):
    """The derivative of `rmsnorm_ref`, written out: with rstd =
    rsqrt(mean(x^2) + eps) and xhat = x * rstd, all in float32,
      dx     = rstd * (g * scale - xhat * mean(g * scale * xhat))
      dscale = sum over rows of g * xhat.
    x, g: (..., D); scale: (D,). -> (dx in x's dtype, dscale float32)."""
    xf = x.float()
    gf = g.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gs = gf * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale
