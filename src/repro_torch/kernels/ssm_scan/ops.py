"""Public wrappers for the Mamba2 SSD scan and its backward.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/ssm_scan.cu`) or raises; a CPU tensor runs the plain chunked version
(`ref.ssd_chunked_ref`). `ssm_scan.launches` and `ssm_scan_bwd.launches`
count kernel launches, and only those. On CUDA tensors that need a
gradient the scan is a `torch.autograd.Function` whose backward is the
backward kernel; on the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref


class _ScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state):
        y, state = _kernel.ssm_scan_cuda(x, dt, A, B, C, initial_state)
        ssm_scan.launches += 1
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        x, dt, A, B, C, h0 = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssm_scan_bwd(x, dt, A, B, C, gy.contiguous(),
                                           gstate.contiguous(),
                                           initial_state=h0)
        return dx, ddt, dA, dB, dC, None


def ssm_scan(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """Mamba2 SSD scan (see `ref.ssd_sequential_ref` for the recurrence).

    x: (Bb,S,H,P), dt: (Bb,S,H) (already softplus'ed), A: (H,) negative,
    B/C: (Bb,S,N), all float32; initial_state: (Bb,H,P,N) or None (zeros).
    Returns (y (Bb,S,H,P), final_state (Bb,H,P,N)), float32.

    `chunk` is the plain version's chunk length (halved until it divides
    S, as in the JAX package); the kernel walks 64-row chunks for any S.
    The function does not depend on it. Both start the scan from
    `initial_state` (the JAX wrapper folds it in after a zero-state scan:
    the same function). On the card a gradient reaches x, dt, A, B and C;
    an `initial_state` that requires one raises (no training path passes
    one)."""
    tensors = (x, dt, A, B, C) + (() if initial_state is None
                                  else (initial_state,))
    if not runtime.use_kernel(*tensors):
        return _ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                                    initial_state=initial_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if initial_state is not None and initial_state.requires_grad:
            raise NotImplementedError(
                "the SSD scan's backward kernel takes no gradient to "
                "initial_state (no training path passes one)")
        return _ScanFn.apply(x, dt, A, B, C, initial_state)
    out = _kernel.ssm_scan_cuda(x, dt, A, B, C, initial_state)
    ssm_scan.launches += 1
    return out


def ssm_scan_bwd(x, dt, A, B, C, gy, gstate=None, initial_state=None):
    """The backward of `ssm_scan` for the gradients gy of y and gstate of
    the final state (None: zero), initial_state a constant start. ->
    (dx, ddt, dA, dB, dC)."""
    tensors = [t for t in (x, dt, A, B, C, gy, gstate, initial_state)
               if t is not None]
    if not runtime.use_kernel(*tensors):
        return _ref.ssd_bwd_ref(x, dt, A, B, C, gy, gstate, initial_state)
    out = _kernel.ssm_scan_bwd_cuda(x, dt, A, B, C, gy, gstate,
                                    initial_state)
    ssm_scan_bwd.launches += 1
    return out


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
