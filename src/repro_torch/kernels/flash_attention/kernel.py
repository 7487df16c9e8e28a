"""ctypes launch of the flash-attention CUDA kernel
(`csrc/flash_attention.cu`): argument checks, output allocation, launch on
the current stream, and the launch's error check."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.models.config import HEAD_DIM_MULTIPLE, MAX_HEAD_DIM

NAME = "flash_attention"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                 + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])
# the float32 kernel's query rows per block: its q_per_kv may not exceed
# it (the bfloat16 kernel splits a larger GQA group over blocks)
MAX_Q_PER_KV = 64


def _lib():
    lib = runtime.load(NAME)
    fn = lib.flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    bwd = lib.flash_attention_bwd
    bwd.argtypes, bwd.restype = _BWD_ARGTYPES, ctypes.c_int
    lib.flash_attention_bwd_clusters.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_bwd_clusters.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, softcap):
    floats = (torch.float32, torch.bfloat16)
    runtime.check_tensor("q", q, 4, floats)
    runtime.check_tensor("k", k, 4, (q.dtype,))
    runtime.check_tensor("v", v, 4, (q.dtype,))
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, hd) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype == torch.float32 and Hq // Hkv > MAX_Q_PER_KV:
        raise ValueError(f"q_per_kv {Hq // Hkv} exceeds {MAX_Q_PER_KV} "
                         f"(float32)")
    if not 0 < hd <= MAX_HEAD_DIM or hd % HEAD_DIM_MULTIPLE:
        raise ValueError(f"head_dim {hd} is not a multiple of "
                         f"{HEAD_DIM_MULTIPLE} in 1..{MAX_HEAD_DIM}")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    return B, S, Hq, Hkv, hd


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, with_lse: bool = False):
    """q: (B,S,Hq,hd); k/v: (B,S,Hkv,hd), same dtype as q (float32 or
    bfloat16). All contiguous on one CUDA device; head_dim a multiple of 4
    up to 256; q_per_kv up to MAX_Q_PER_KV for float32, any for bfloat16.
    -> (B,S,Hq,hd), or with `with_lse` (out, the log-sum-exp of each query
    row's kept scores (B,Hq,S) float32), which the backward takes."""
    B, S, Hq, Hkv, hd = _check(q, k, v, window, softcap)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    code = lib.flash_attention(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        ctypes.c_void_p(None) if lse is None else runtime.ptr(lse), B,
        S, Hq, Hkv, hd, int(bool(causal)), int(window), float(softcap),
        runtime.dtype_code(q.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """The backward of `flash_attention_cuda`, any q_per_kv: q, o, do
    (B,S,Hq,hd); k, v (B,S,Hkv,hd), one dtype, all contiguous; lse (B,Hq,S)
    float32 from the forward. bfloat16 runs on the tensor cores (P and dS
    rounded to bf16 before their products, as `ref.flash_attention_bwd_mma
    _ref` models; the GQA sums of dK and dV on chip), float32 in scalar
    float32 arithmetic. -> (dq, dk, dv) in the inputs' dtype, the same bits
    on every run."""
    B, S, Hq, Hkv, hd = _check(q, k, v, window, softcap)
    runtime.check_tensor("o", o, 4, (q.dtype,))
    runtime.check_tensor("do", do, 4, (q.dtype,))
    runtime.check_tensor("lse", lse, 3, (torch.float32,), align=False)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, Hq, S):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=q.device)
    # each row's D (float32); bfloat16 keeps lse log2(e) beside it
    dsum = torch.empty((B, Hq, S) + ((2,) if q.dtype == torch.bfloat16
                                     else ()), **f32)
    if q.dtype == torch.bfloat16:
        # the float32 sums of each GQA cluster, where a kv head's group
        # takes more than one (q_per_kv past 8)
        n_cl = lib.flash_attention_bwd_clusters(Hq, Hkv)
        scratch = ((torch.empty((2, n_cl, B, S, Hkv, hd), **f32), None)
                   if n_cl > 1 else (None, None))
    else:
        # each query head's share of its kv head's dK, dV (q_per_kv > 1)
        scratch = ((torch.empty(q.shape, **f32), torch.empty(q.shape, **f32))
                   if Hq != Hkv else (None, None))
    code = lib.flash_attention_bwd(
        *(runtime.ptr(t) for t in (q, k, v, o, do, lse, dsum)),
        *(ctypes.c_void_p(None) if t is None else runtime.ptr(t)
          for t in scratch),
        *(runtime.ptr(t) for t in (dq, dk, dv)),
        B, S, Hq, Hkv, hd, int(bool(causal)), int(window), float(softcap),
        runtime.dtype_code(q.dtype), runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return dq, dk, dv
