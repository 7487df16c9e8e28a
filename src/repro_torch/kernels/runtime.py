"""Kernel runtime: build the CUDA sources, load them, and pick kernel or
plain version by the tensor's device.

Each kernel is one `csrc/<name>.cu` file with a plain C interface (helpers
shared by the kernels live in `csrc/*.cuh`). At first use in a process
`load(name)` compiles it with nvcc for `sm_90a` into `build/lib<name>.so`
at the repository root (reused while it is newer than its source and the
shared headers) and loads it with ctypes. `build_all()` starts one nvcc per
source at once, so a fresh checkout builds in the time of the slowest file.

The choice between a kernel and its plain PyTorch version is made by
`use_kernel` from the device of the tensors alone: a CUDA tensor launches the
kernel (or the wrapper raises), a CPU tensor takes the plain version. There
is no configuration switch and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from repro_torch.models.config import (HEAD_DIM_MULTIPLE, MAX_HEAD_DIM,
                                       MAX_PAGE_SIZE)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("paged_decode_attention", "paged_prefill_attention",
           "decode_attention", "flash_attention", "ssm_scan", "rmsnorm")
# --split-compile=0 optimises a source's kernel instances in parallel on
# every core: the same code, in less than half the build time for the
# prefill source's 23 instances.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}      # name -> nvcc output (ptxas register use)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or a shared header."""
    lib = _lib_path(name)
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(
        p.stat().st_mtime for p in sources)


def build_all(names: Sequence[str] = KERNELS) -> None:
    """Compile every stale source, one nvcc process per file, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (its cudaGetLastError)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def resolve_device(device=None) -> torch.device:
    """The device the port's entry points run on: CUDA unless the caller
    asks for another. Without a card a CUDA request raises; nothing silently
    runs on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (take the plain version). Mixed or other
    devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or all on the "
                     f"CPU, got {sorted(kinds)}")


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def int32_on(values: Iterable, device: torch.device) -> torch.Tensor:
    """A host int32 vector on `device` without synchronizing the device:
    a CUDA copy goes through pinned memory and is queued on the current
    stream (a pageable host->device copy would wait for the queue)."""
    return host_array_on(np.asarray(values, dtype=np.int32).reshape(-1),
                         device)


def host_array_on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """`int32_on` for an array of any shape and dtype."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return host.clone().to(device)
    return host.pin_memory().to(device, non_blocking=True)


def check_tensor(name: str, t: torch.Tensor, ndim: int, dtypes,
                 align: bool = True) -> None:
    """Rank, dtype and contiguity; a tensor of data rows (not int32
    indices, not `align=False` scalars) must also start on 8 bytes."""
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.dtype != torch.int32 and t.data_ptr() % 8:
        raise ValueError(f"{name} must start on an 8-byte boundary (the "
                         f"kernels read rows in 8-byte pieces)")


def check_limits(page_size: int, head_dim: int,
                 kv_dtype: torch.dtype = torch.float32) -> None:
    """Raise on a page size or head_dim the kernels do not take: past their
    shared-memory limits, or a head_dim whose rows of `kv_dtype` they cannot
    read in 8-byte pieces — a multiple of `HEAD_DIM_MULTIPLE` for float
    pools, of 8 for int8 / fp8 (`ModelConfig.validate_paged` checks the same
    at engine start)."""
    if not 0 < page_size <= MAX_PAGE_SIZE:
        raise ValueError(f"page_size {page_size} outside the kernels' range "
                         f"1..{MAX_PAGE_SIZE}")
    multiple = max(HEAD_DIM_MULTIPLE, 8 // kv_dtype.itemsize)
    if not 0 < head_dim <= MAX_HEAD_DIM or head_dim % multiple:
        raise ValueError(f"head_dim {head_dim} is not a multiple of "
                         f"{multiple} in 1..{MAX_HEAD_DIM}")


# Type codes of the C interfaces: the query (and output) type, and the
# type a KV pool stores (codes 0 and 1 mean the same in both).
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLOAT_POOLS = (torch.float32, torch.bfloat16)
QUANT_POOLS = (torch.int8, torch.float8_e4m3fn)
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}


def dtype_code(dtype: torch.dtype) -> int:
    """The query type's code (float32 or bfloat16)."""
    if dtype not in Q_DTYPES:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return Q_DTYPES[dtype]


def kv_dtype_code(dtype: torch.dtype) -> int:
    """A pool's storage type code."""
    if dtype not in KV_DTYPES:
        raise ValueError(f"pools store float32, bfloat16, int8 or "
                         f"float8_e4m3fn, got {dtype}")
    return KV_DTYPES[dtype]


def check_pools(k_pages: torch.Tensor, v_pages: torch.Tensor, k_scales,
                v_scales) -> None:
    """Pools of one storage type: float32 / bfloat16 with no scales, or
    int8 / float8_e4m3fn with float32 scales (n_pages, Hkv)."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("k_scales and v_scales come together")
    allowed = QUANT_POOLS if quant else FLOAT_POOLS
    check_tensor("k_pages", k_pages, 4, allowed)
    check_tensor("v_pages", v_pages, 4, (k_pages.dtype,))
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} differs from "
                         f"k_pages {tuple(k_pages.shape)}")
    if not quant:
        return
    check_tensor("k_scales", k_scales, 2, (torch.float32,), align=False)
    check_tensor("v_scales", v_scales, 2, (torch.float32,), align=False)
    want = (k_pages.shape[0], k_pages.shape[2])
    if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
        raise ValueError(f"scales must be (n_pages, Hkv) = {want}, got "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)}")

