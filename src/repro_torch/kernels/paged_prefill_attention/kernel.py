"""ctypes launch of the paged chunked-prefill CUDA kernel
(`csrc/paged_prefill_attention.cu`): argument checks, output allocation,
launch on the current stream, and the launch's error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

NAME = "paged_prefill_attention"
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _lib():
    lib = runtime.load(NAME)
    fn = lib.paged_prefill_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def paged_prefill_attention_cuda(q, k_pages, v_pages, block_rows, offsets,
                                 lens):
    """q: (R, C, Hq, hd); k/v_pages: (n_pages, page, Hkv, hd), same dtype as
    q (float32 or bfloat16); block_rows: (R, P) int32; offsets/lens: (R,)
    int32. All contiguous on one CUDA device; page size and head_dim within
    the kernels' limits (`runtime.check_limits`). -> (R, C, Hq, hd), rows past
    lens[r] written as zeros."""
    floats = (torch.float32, torch.bfloat16)
    runtime.check_tensor("q", q, 4, floats)
    runtime.check_tensor("k_pages", k_pages, 4, (q.dtype,))
    runtime.check_tensor("v_pages", v_pages, 4, (q.dtype,))
    runtime.check_tensor("block_rows", block_rows, 2, (torch.int32,))
    runtime.check_tensor("offsets", offsets, 1, (torch.int32,))
    runtime.check_tensor("lens", lens, 1, (torch.int32,))
    R, C, Hq, hd = q.shape
    n_pages, ps, Hkv, hd_kv = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_kv != hd or Hq % Hkv:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if block_rows.shape[0] != R or offsets.shape[0] != R \
            or lens.shape[0] != R:
        raise ValueError("block_rows, offsets and lens need one entry per row")
    runtime.check_limits(ps, hd)
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.paged_prefill_attention(
        runtime.ptr(q), runtime.ptr(k_pages), runtime.ptr(v_pages),
        runtime.ptr(block_rows), runtime.ptr(offsets), runtime.ptr(lens),
        runtime.ptr(out), R, C, Hq, Hkv, hd, ps, block_rows.shape[1],
        n_pages, runtime.dtype_code(q.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return out
