"""ctypes launch of the paged chunked-prefill CUDA kernel
(`csrc/paged_prefill_attention.cu`): argument checks, output allocation,
launch on the current stream, and the launch's error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

NAME = "paged_prefill_attention"
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _lib():
    lib = runtime.load(NAME)
    fn = lib.paged_prefill_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def paged_prefill_attention_cuda(q, k_pages, v_pages, block_rows, offsets,
                                 lens, k_scales=None, v_scales=None):
    """q: (R, C, Hq, hd) float32 or bfloat16; k/v_pages: (n_pages, page,
    Hkv, hd), float32 or bfloat16 (either, whatever q's type), or int8 /
    float8_e4m3fn with f32 k/v_scales (n_pages, Hkv); block_rows: (R, P)
    int32; offsets/lens: (R,) int32. All contiguous on one CUDA device; page
    size and head_dim within the kernels' limits (`runtime.check_limits`).
    -> (R, C, Hq, hd) in q's dtype, rows past lens[r] written as zeros."""
    runtime.check_tensor("q", q, 4, tuple(runtime.Q_DTYPES))
    runtime.check_pools(k_pages, v_pages, k_scales, v_scales)
    runtime.check_tensor("block_rows", block_rows, 2, (torch.int32,))
    runtime.check_tensor("offsets", offsets, 1, (torch.int32,))
    runtime.check_tensor("lens", lens, 1, (torch.int32,))
    R, C, Hq, hd = q.shape
    n_pages, ps, Hkv, hd_kv = k_pages.shape
    if hd_kv != hd or Hq % Hkv:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if block_rows.shape[0] != R or offsets.shape[0] != R \
            or lens.shape[0] != R:
        raise ValueError("block_rows, offsets and lens need one entry per row")
    runtime.check_limits(ps, hd, k_pages.dtype)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(None)
    lib = _lib()
    code = lib.paged_prefill_attention(
        runtime.ptr(q), runtime.ptr(k_pages), runtime.ptr(v_pages),
        null if k_scales is None else runtime.ptr(k_scales),
        null if v_scales is None else runtime.ptr(v_scales),
        runtime.ptr(block_rows), runtime.ptr(offsets), runtime.ptr(lens),
        runtime.ptr(out), R, C, Hq, Hkv, hd, ps, block_rows.shape[1],
        n_pages, runtime.dtype_code(q.dtype),
        runtime.kv_dtype_code(k_pages.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return out
