"""Public wrapper for the row RMSNorm.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/rmsnorm.cu`) or raises; a CPU tensor runs the plain version
(`ref.py`). `rmsnorm.launches` counts kernel launches, and only those.

Every norm of the port's models calls it through `models.layers.rmsnorm`
(norm1, norm2, the final norm, q_norm / k_norm, Mamba2's gated norm). The
JAX package's models normalise through plain jnp, which the plain version
repeats step for step.
"""
from __future__ import annotations

from repro_torch.kernels import runtime
from repro_torch.kernels.rmsnorm import kernel as _kernel
from repro_torch.kernels.rmsnorm import ref as _ref


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,). The mean of squares in float32, the output
    in x's dtype."""
    if not runtime.use_kernel(x, scale):
        return _ref.rmsnorm_ref(x, scale, eps)
    out = _kernel.rmsnorm_cuda(x, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
