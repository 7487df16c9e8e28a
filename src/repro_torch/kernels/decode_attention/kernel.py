"""ctypes launch of the dense-cache decode CUDA kernel
(`csrc/decode_attention.cu`): argument checks, the split of each slot's
cache rows over the thread blocks of one cluster, output allocation, launch
on the current stream, and the launch's error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.paged_decode_attention.kernel import split_pages
from repro_torch.models.config import HEAD_DIM_MULTIPLE, MAX_HEAD_DIM

NAME = "decode_attention"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
# rows per unit of the split: a split is a whole number of units, each a
# multiple of every kUnroll the scalar kernel picks (16 / NI)
SPLIT_UNIT = 16


def _lib():
    lib = runtime.load(NAME)
    fn = lib.decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def split_rows(B: int, Hkv: int, S: int, n_sm: int):
    """(splits, rows_per_split): the paged kernel's split (`split_pages`)
    over the S cache rows cut into SPLIT_UNIT-row units. The split is cut
    from S, not from the lengths (they stay on the card): a caller that
    knows its live rows passes a cache view that ends there."""
    splits, per = split_pages(B, Hkv, -(-S // SPLIT_UNIT), n_sm)
    return splits, per * SPLIT_UNIT


def _check_cache(name: str, t: torch.Tensor, dtype, hd: int) -> None:
    if t.dim() != 4 or t.dtype != dtype:
        raise ValueError(f"{name} must be a 4-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != hd:
        raise ValueError(f"{name} needs contiguous (Hkv, hd) rows")
    if t.stride(0) % HEAD_DIM_MULTIPLE or t.stride(1) % HEAD_DIM_MULTIPLE \
            or t.data_ptr() % 8:
        raise ValueError(f"{name} rows must start on 8-byte boundaries (the "
                         f"kernel reads them in 8-byte pieces)")


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """q: (B,1,Hq,hd) contiguous; k/v_cache: (B,S,Hkv,hd), same dtype as q
    (float32 or bfloat16), each (Hkv, hd) row contiguous, slot and row
    strides free (a slice of a larger cache works); lengths: (B,) int32.
    All on one CUDA device. -> (B,1,Hq,hd)."""
    runtime.check_tensor("q", q, 4, (torch.float32, torch.bfloat16))
    runtime.check_tensor("lengths", lengths, 1, (torch.int32,))
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    _check_cache("k_cache", k_cache, q.dtype, hd)
    _check_cache("v_cache", v_cache, q.dtype, hd)
    if T != 1:
        raise ValueError(f"decode takes one query token per slot, got {T}")
    if k_cache.shape != (B, S, Hkv, hd) or v_cache.shape != k_cache.shape \
            or v_cache.stride() != k_cache.stride() or Hq % Hkv:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if lengths.shape[0] != B:
        raise ValueError("lengths needs one entry per slot")
    if not 0 < hd <= MAX_HEAD_DIM or hd % HEAD_DIM_MULTIPLE:
        raise ValueError(f"head_dim {hd} is not a multiple of "
                         f"{HEAD_DIM_MULTIPLE} in 1..{MAX_HEAD_DIM}")
    splits, per = split_rows(B, Hkv, S, runtime.sm_count(q.device))
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.decode_attention(
        runtime.ptr(q), runtime.ptr(k_cache), runtime.ptr(v_cache),
        runtime.ptr(lengths), runtime.ptr(out), B, Hq, Hkv, hd, S,
        k_cache.stride(0), k_cache.stride(1), splits, per,
        runtime.dtype_code(q.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return out
