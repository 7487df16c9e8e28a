"""ctypes launch of the RMSNorm CUDA kernel (`csrc/rmsnorm.cu`): argument
checks, output allocation, launch on the current stream, and the launch's
error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

NAME = "rmsnorm"
# 16-byte pieces a row may have: 256 threads of a block, 8 pieces each
MAX_PIECES = 256 * 8
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])


def _lib():
    lib = runtime.load(NAME)
    fn = lib.rmsnorm
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def _check(x, scale, g=None) -> int:
    """The rows the kernels take (see `rmsnorm_cuda`); -> D."""
    if x.dtype not in runtime.Q_DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    rows = (x,) if g is None else (x, g)
    if g is not None and (g.dtype != x.dtype or g.shape != x.shape):
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} must match x "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.dim() < 1 or not all(t.is_contiguous() for t in rows):
        raise ValueError("x (and g) must be contiguous, at least 1-D")
    runtime.check_tensor("scale", scale, 1, (torch.float32,))
    D = x.shape[-1]
    per_piece = 16 // x.element_size()
    if (D < 1 or D % per_piece or D // per_piece > MAX_PIECES
            or scale.shape != (D,)):
        raise ValueError(f"D {D} must be a multiple of {per_piece} up to "
                         f"{per_piece * MAX_PIECES} and match scale "
                         f"{tuple(scale.shape)}")
    if any(t.data_ptr() % 16 for t in rows + (scale,)):
        raise ValueError("x, scale (and g) must start on 16-byte boundaries")
    return D


def rmsnorm_cuda(x, scale, eps: float = 1e-6):
    """x: (..., D) float32 or bfloat16, contiguous; scale: (D,) float32.
    Rows are read 16 bytes at a time: D a multiple of 4 (float32) or 8
    (bfloat16), at most MAX_PIECES pieces (8192 / 16384), both tensors
    16-byte aligned. -> out like x."""
    D = _check(x, scale)
    out = torch.empty_like(x)
    lib = _lib()
    code = lib.rmsnorm(runtime.ptr(x), runtime.ptr(scale), runtime.ptr(out),
                       x.numel() // D, D, float(eps),
                       runtime.dtype_code(x.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return out


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
                 + [ctypes.c_int] + [ctypes.c_void_p])


def _bwd_lib():
    lib = _lib()
    fn = lib.rmsnorm_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    lib.rmsnorm_bwd_partial_rows.argtypes = [ctypes.c_int] * 3
    lib.rmsnorm_bwd_partial_rows.restype = ctypes.c_int
    return lib


def rmsnorm_bwd_cuda(x, scale, g, eps: float = 1e-6):
    """The backward of `rmsnorm_cuda`: x, g (..., D) of one type, both
    contiguous; scale (D,) float32; the limits of the forward. -> (dx like
    x, dscale (D,) float32), dscale reduced in a fixed order (the same bits
    on every run)."""
    D = _check(x, scale, g)
    lib = _bwd_lib()
    R, code = x.numel() // D, runtime.dtype_code(x.dtype)
    rows = lib.rmsnorm_bwd_partial_rows(R, D, code)
    if rows < 1:
        raise RuntimeError(f"rmsnorm_bwd cannot size its scratch for {R} "
                           f"rows of {D} ({x.dtype})")
    dx = torch.empty_like(x)
    dscale = torch.empty(D, dtype=torch.float32, device=x.device)
    partial = torch.empty((rows, D), dtype=torch.float32, device=x.device)
    code = lib.rmsnorm_bwd(runtime.ptr(x), runtime.ptr(scale), runtime.ptr(g),
                           runtime.ptr(dx), runtime.ptr(partial),
                           runtime.ptr(dscale), R, D, float(eps), code,
                           runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return dx, dscale
