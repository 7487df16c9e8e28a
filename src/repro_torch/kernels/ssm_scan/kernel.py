"""ctypes launch of the SSD scan CUDA kernel (`csrc/ssm_scan.cu`): argument
checks, output allocation, launch on the current stream, and the launch's
error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

NAME = "ssm_scan"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the kernel's largest head_dim P and state N (its shared-memory tiles);
# both are read as float4, so multiples of 4
MAX_DIM = 64


def _lib():
    lib = runtime.load(NAME)
    fn = lib.ssm_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def ssm_scan_cuda(x, dt, A, B, C, initial_state=None):
    """x: (Bb,S,H,P), dt: (Bb,S,H), A: (H,), B/C: (Bb,S,N), initial_state
    (Bb,H,P,N) or None; all float32, contiguous, on one CUDA device. P and
    N multiples of 4 up to 64. -> (y (Bb,S,H,P), final state (Bb,H,P,N)),
    float32."""
    f32 = (torch.float32,)
    runtime.check_tensor("x", x, 4, f32)
    runtime.check_tensor("dt", dt, 3, f32)
    runtime.check_tensor("A", A, 1, f32)
    runtime.check_tensor("B", B, 3, f32)
    runtime.check_tensor("C", C, 3, f32)
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (Bb, S, H) or A.shape != (H,) \
            or B.shape != (Bb, S, N) or C.shape != B.shape:
        raise ValueError(
            f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    for name, d in (("head_dim P", P), ("state N", N)):
        if not 0 < d <= MAX_DIM or d % 4:
            raise ValueError(f"{name} {d} is not a multiple of 4 in "
                             f"4..{MAX_DIM}")
    if initial_state is not None:
        runtime.check_tensor("initial_state", initial_state, 4, f32)
        if initial_state.shape != (Bb, H, P, N):
            raise ValueError(f"initial_state must be {(Bb, H, P, N)}, got "
                             f"{tuple(initial_state.shape)}")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    h0 = (ctypes.c_void_p(None) if initial_state is None
          else runtime.ptr(initial_state))
    lib = _lib()
    code = lib.ssm_scan(runtime.ptr(x), runtime.ptr(dt), runtime.ptr(A),
                        runtime.ptr(B), runtime.ptr(C), h0, runtime.ptr(y),
                        runtime.ptr(state), Bb, S, H, P, N,
                        runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return y, state
