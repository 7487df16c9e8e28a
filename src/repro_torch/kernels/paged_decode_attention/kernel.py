"""ctypes launch of the paged decode CUDA kernel
(`csrc/paged_decode_attention.cu`): argument checks, the split of each
slot's pages over the thread blocks of one cluster, output allocation,
launch on the current stream, and the launch's error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

NAME = "paged_decode_attention"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# thread blocks to aim for on each SM: split-KV cuts every (slot, kv head)
# into runs of pages until the grid holds about this many per SM (on an
# H100, 2 against 1, 4 and 8 was the fastest at qwen3-8b's decode shapes
# and even at qwen2-1.5b's: PERF.md)
BLOCKS_PER_SM = 2
# the runs of one (slot, kv head) form one thread-block cluster, which the
# kernel merges in distributed shared memory: at most the portable cluster
# size (kDecodeMaxSplits in csrc/flash_decode.cuh)
MAX_SPLITS = 8


def _lib():
    lib = runtime.load(NAME)
    fn = lib.paged_decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib


def split_pages(B: int, Hkv: int, P: int, n_sm: int):
    """(splits, units_per_split): the fewest equal runs of P units (here
    block-table columns; the dense decode kernel's row units) that give the
    grid about BLOCKS_PER_SM blocks per SM, at most MAX_SPLITS runs (one
    cluster). Every unit has a run and no run is empty."""
    if P == 0:
        return 1, 1
    want = min(P, MAX_SPLITS, -(-BLOCKS_PER_SM * n_sm // max(B * Hkv, 1)))
    per = -(-P // want)
    return -(-P // per), per


def paged_decode_attention_cuda(q, k_pages, v_pages, block_table, lengths,
                                k_scales=None, v_scales=None):
    """q: (B,1,Hq,hd) float32 or bfloat16; k/v_pages: (n_pages, page, Hkv,
    hd), float32 or bfloat16 (either, whatever q's type), or int8 /
    float8_e4m3fn with f32 k/v_scales (n_pages, Hkv); block_table: (B, P)
    int32; lengths: (B,) int32. All contiguous on one CUDA device; page size
    and head_dim within the kernels' limits (`runtime.check_limits`).
    -> (B,1,Hq,hd) in q's dtype."""
    runtime.check_tensor("q", q, 4, tuple(runtime.Q_DTYPES))
    runtime.check_pools(k_pages, v_pages, k_scales, v_scales)
    runtime.check_tensor("block_table", block_table, 2, (torch.int32,))
    runtime.check_tensor("lengths", lengths, 1, (torch.int32,))
    B, T, Hq, hd = q.shape
    n_pages, ps, Hkv, hd_kv = k_pages.shape
    P = block_table.shape[1]
    if T != 1:
        raise ValueError(f"decode takes one query token per slot, got {T}")
    if hd_kv != hd or Hq % Hkv:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if block_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("block_table and lengths need one row per slot")
    runtime.check_limits(ps, hd, k_pages.dtype)
    splits, per = split_pages(B, Hkv, P, runtime.sm_count(q.device))
    out = torch.empty_like(q)
    null = ctypes.c_void_p(None)
    lib = _lib()
    code = lib.paged_decode_attention(
        runtime.ptr(q), runtime.ptr(k_pages), runtime.ptr(v_pages),
        null if k_scales is None else runtime.ptr(k_scales),
        null if v_scales is None else runtime.ptr(v_scales),
        runtime.ptr(block_table), runtime.ptr(lengths), runtime.ptr(out),
        B, Hq, Hkv, hd, ps, P, n_pages, splits, per,
        runtime.dtype_code(q.dtype), runtime.kv_dtype_code(k_pages.dtype),
        runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return out
