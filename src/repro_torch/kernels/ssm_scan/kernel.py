"""ctypes launch of the SSD scan CUDA kernel (`csrc/ssm_scan.cu`): argument
checks, the split of each (batch, head)'s sequence over the thread blocks of
one cluster, output allocation, launch on the current stream, and the
launch's error check."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

NAME = "ssm_scan"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the kernel's largest head_dim P and state N (its shared-memory tiles);
# both are read as float4, so multiples of 4
MAX_DIM = 64
# rows a chunk, and chunks a block holds at once (a super-chunk: two
# chunks side by side, one a half of the block); a segment of at most
# KEEP_CHUNKS chunks keeps its y in registers across the cluster exchange
CHUNK = 64
KEEP_CHUNKS = 2
# the segments of one (batch, head) form one thread-block cluster, which
# combines their states in distributed shared memory: at most the portable
# cluster size (kMaxRanks in csrc/ssm_scan.cu)
MAX_RANKS = 8


def _lib():
    lib = runtime.load(NAME)
    fn = lib.ssm_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    fit = lib.ssm_scan_active_clusters
    fit.argtypes, fit.restype = [ctypes.c_int], ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def card_blocks(device: torch.device) -> int:
    """Blocks of the kernel the card holds at once
    (cudaOccupancyMaxActiveClusters at a cluster of one)."""
    lib = _lib()
    with torch.cuda.device(device):
        n = lib.ssm_scan_active_clusters(1)
    if n < 0:
        runtime.check(lib, NAME, -n)
    if n == 0:
        raise RuntimeError(f"{NAME}: no block of the kernel fits on the card")
    return n


def split_sequence(Bb: int, H: int, S: int, slots: int):
    """(ranks, chunks_per_rank): the sequence of each (batch, head) cut
    into `ranks` segments of whole CHUNK-row chunks, one a thread block of
    one cluster. One segment where Bb * H already fills the card (`slots`:
    the blocks it holds at once); else the fewest ranks, at most MAX_RANKS,
    that leave every segment at most KEEP_CHUNKS chunks. Every rank has
    rows, and the last holds the sequence's end."""
    chunks = -(-S // CHUNK)
    if chunks <= KEEP_CHUNKS or Bb * H >= slots:
        return 1, chunks
    want = min(MAX_RANKS, -(-chunks // KEEP_CHUNKS))
    per = -(-chunks // want)
    return -(-chunks // per), per


def split_sequence_bwd(S: int):
    """(ranks, chunks_per_rank) of the backward: each (batch, head)'s
    sequence cut into `ranks` segments of whole CHUNK-row chunks, one a
    thread block of one cluster: one chunk a rank up to MAX_RANKS chunks,
    then the fewest chunks a rank that MAX_RANKS ranks hold. Every rank has
    rows, and the last holds the sequence's end. (A rank of several chunks
    recomputes the states of its earlier chunks for each later one, so the
    backward splits wherever it can, whatever the batch.)"""
    chunks = -(-S // CHUNK)
    if chunks <= 1:
        return 1, chunks
    per = -(-chunks // MAX_RANKS)
    return -(-chunks // per), per


def _aligned(t):
    """The tensor, or a copy of it that starts on 16 bytes (the kernel
    moves rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssm_scan_cuda(x, dt, A, B, C, initial_state=None, ranks=None):
    """x: (Bb,S,H,P), dt: (Bb,S,H), A: (H,), B/C: (Bb,S,N), initial_state
    (Bb,H,P,N) or None; all float32, contiguous, on one CUDA device. P and
    N multiples of 4 up to 64. -> (y (Bb,S,H,P), final state (Bb,H,P,N)),
    float32. `ranks`: segments a (batch, head), at most MAX_RANKS; the
    planner's (`split_sequence`) when None, which is how the model calls it
    (chip_smoke.py times other splits with it)."""
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
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    if initial_state is not None:
        initial_state = _aligned(initial_state)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    h0 = (ctypes.c_void_p(None) if initial_state is None
          else runtime.ptr(initial_state))
    if ranks is None:
        ranks, per = split_sequence(Bb, H, S, card_blocks(x.device))
    else:
        chunks = -(-S // CHUNK)
        per = -(-chunks // min(max(ranks, 1), MAX_RANKS, max(chunks, 1)))
        ranks = -(-chunks // per) if chunks else 1
    lib = _lib()
    code = lib.ssm_scan(runtime.ptr(x), runtime.ptr(dt), runtime.ptr(A),
                        runtime.ptr(B), runtime.ptr(C), h0, runtime.ptr(y),
                        runtime.ptr(state), Bb, S, H, P, N, ranks, per,
                        runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return y, state


_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])


def _bwd_lib():
    lib = _lib()
    fn = lib.ssm_scan_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    return lib


def ssm_scan_bwd_cuda(x, dt, A, B, C, gy, gstate=None, initial_state=None):
    """The backward of `ssm_scan_cuda` (chunked, on the TF32 tensor cores in
    3xTF32, each (batch, head)'s chunks split over a cluster as
    `split_sequence_bwd` says): the inputs as there, gy like y, gstate like
    the final state (None: zero), initial_state a constant start (None:
    zero); P and N multiples of 4 up to 64. -> (dx, ddt, dA, dB, dC) like
    x, dt, A, B, C, the same bits on every run. Scratch: each head's share
    of dB and dC, (Bb, H, S, N) each, and each segment's share of dA."""
    f32 = (torch.float32,)
    for name, t, nd in (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 3),
                        ("C", C, 3), ("gy", gy, 4)):
        runtime.check_tensor(name, t, nd, f32)
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (Bb, S, H) or A.shape != (H,) or B.shape != (Bb, S, N) \
            or C.shape != B.shape or gy.shape != x.shape:
        raise ValueError(
            f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"gy {tuple(gy.shape)}")
    for name, d in (("head_dim P", P), ("state N", N)):
        if not 0 < d <= MAX_DIM or d % 4:
            raise ValueError(f"{name} {d} is not a multiple of 4 in "
                             f"4..{MAX_DIM}")
    for name, t in (("gstate", gstate), ("initial_state", initial_state)):
        if t is not None:
            runtime.check_tensor(name, t, 4, f32)
            if t.shape != (Bb, H, P, N):
                raise ValueError(f"{name} must be {(Bb, H, P, N)}, got "
                                 f"{tuple(t.shape)}")
    x, B, C, gy = _aligned(x), _aligned(B), _aligned(C), _aligned(gy)
    if initial_state is not None:
        initial_state = _aligned(initial_state)
    ranks, per = split_sequence_bwd(S)
    lib = _bwd_lib()
    dev = x.device
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dB_part = torch.empty((Bb, H, S, N), dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((Bb, H, ranks), dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(None)
    code = lib.ssm_scan_bwd(
        *(runtime.ptr(t) for t in (x, dt, A, B, C)),
        null if initial_state is None else runtime.ptr(initial_state),
        runtime.ptr(gy), null if gstate is None else runtime.ptr(gstate),
        *(runtime.ptr(t) for t in (dx, ddt, dA, dB, dC, dB_part, dC_part,
                                   dA_part)),
        Bb, S, H, P, N, ranks, per, runtime.stream_ptr())
    runtime.check(lib, NAME, code)
    return dx, ddt, dA, dB, dC
