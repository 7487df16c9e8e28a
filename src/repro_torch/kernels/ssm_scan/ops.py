"""Public wrapper for the Mamba2 SSD scan.

A CUDA tensor launches the hand-written kernel (`kernel.py`,
`csrc/ssm_scan.cu`) or raises; a CPU tensor runs the plain chunked version
(`ref.ssd_chunked_ref`). `ssm_scan.launches` counts kernel launches, and
only those.
"""
from __future__ import annotations

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref


def ssm_scan(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """Mamba2 SSD scan (see `ref.ssd_sequential_ref` for the recurrence).

    x: (Bb,S,H,P), dt: (Bb,S,H) (already softplus'ed), A: (H,) negative,
    B/C: (Bb,S,N), all float32; initial_state: (Bb,H,P,N) or None (zeros).
    Returns (y (Bb,S,H,P), final_state (Bb,H,P,N)), float32.

    `chunk` is the plain version's chunk length (halved until it divides
    S, as in the JAX package); the kernel walks 64-row chunks for any S.
    The function does not depend on it. Both start the scan from
    `initial_state` (the JAX wrapper folds it in after a zero-state scan:
    the same function)."""
    tensors = (x, dt, A, B, C) + (() if initial_state is None
                                  else (initial_state,))
    if not runtime.use_kernel(*tensors):
        return _ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                                    initial_state=initial_state)
    out = _kernel.ssm_scan_cuda(x, dt, A, B, C, initial_state)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
