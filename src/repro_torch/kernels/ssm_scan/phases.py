"""Where the SSD scan backward kernel's time goes, block by block, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.phases

Builds a copy of `csrc/ssm_scan.cu` into `build/` with `%globaltimer`
stamps at the phase boundaries of `ssd_bwd_mma` (thread 0 of each block),
runs the backward at zamba2's shapes (80 heads, P = N = 64; B 2 x S 256
and B 1 x S 1,024), and prints the blocks' start times (the waves), their
durations and each phase's mean: phase A (staging and the segment's G and
D), the cluster exchange, the chunk's staging or recomputed states, the
s-major steps (B.C^T and x.gy^T, the decays and rho's rectangle sums, u,
dB), the t-major step (dC) and rho. The stamps cost a few stores a block;
the phase times, not the total, are what this is for.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_scan import kernel as skernel
from repro_torch.kernels.ssm_scan import ops as sops

STAMPS = 16   # stamp slots a block
# (anchor in ssm_scan.cu, stamp inserted before it); 0: start, 1: phase A
# done, 2: exchange done, 3: chunk staged, 4: s-major done, 5: t-major
# done, 6: end, 7: s-major products done, 8: decays and rho's sums done
ANCHORS = [
    ("  // the state before the segment and the gradient after it",
     "STAMP(0);\n"),
    ("    cluster_arrive_release();\n    cluster_wait_acquire();\n"
     "    // h from the earlier", "STAMP(1);\n"),
    ("  // the chunks in reverse: Gam carried back", "STAMP(2);\n"),
    ("    __syncthreads();  // h_c and Gam_c are in", "STAMP(3);\n"),
    ("  switch (k.i) {\n    case 0: store_mp<0>", "STAMP(4);\n"),
    ("  float sum = 0.f;\n  if (k.i == 0) sum = rho(", "STAMP(5);\n"),
    ("  if (k.tid == 0)\n    a.dA_part[", "STAMP(6);\n"),
    ("  // Right to left over the column tiles", "STAMP(7);\n"),
    ("  // 2. u = K^T gy", "STAMP(8);\n"),
]
PHASES = [("phase A", 0, 1), ("exchange", 1, 2), ("chunk staging", 2, 3),
          ("s-major products", 3, 7), ("decays, rho's sums", 7, 8),
          ("u, dB", 8, 4), ("t-major (dC)", 4, 5), ("rho", 5, 6)]


def instrumented_source() -> str:
    src = (runtime.CSRC / "ssm_scan.cu").read_text()
    head = ("namespace ssd_bwd {\n"
            f"__device__ unsigned long long g_stamps[{STAMPS} * 65536];\n"
            "#define STAMP(j) if (threadIdx.x == 0) { unsigned long long t_; "
            "asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_)); "
            f"g_stamps[blockIdx.x * {STAMPS} + (j)] = t_; }}\n")
    assert src.count("namespace ssd_bwd {\n") == 1
    src = src.replace("namespace ssd_bwd {\n", head)
    for anchor, stamp in ANCHORS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, stamp + anchor)
    return src + (
        "\nextern \"C\" int ssm_bwd_stamps(void* dst, int n) {\n"
        "  return (int)cudaMemcpyFromSymbol(dst, ssd_bwd::g_stamps,\n"
        "                                   sizeof(unsigned long long) * n);\n"
        "}\n")


def build() -> ctypes.CDLL:
    runtime.BUILD.mkdir(parents=True, exist_ok=True)
    src = runtime.BUILD / "ssm_scan_phases.cu"
    lib = runtime.BUILD / "libssm_scan_phases.so"
    src.write_text(instrumented_source())
    cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC),
           "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    dll = ctypes.CDLL(str(lib))
    dll.kernel_error_string.argtypes = [ctypes.c_int]
    dll.kernel_error_string.restype = ctypes.c_char_p
    return dll


def report(lib, Bb: int, S: int, H: int = 80, P: int = 64, N: int = 64):
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(generator=gen, device="cuda")
    x = torch.randn(Bb, S, H, P, **kw)
    dt = torch.nn.functional.softplus(torch.randn(Bb, S, H, **kw)) * 0.1
    A = -torch.exp(torch.randn(H, **kw))
    B = torch.randn(Bb, S, N, **kw) * 0.3
    C = torch.randn(Bb, S, N, **kw) * 0.3
    gy = torch.randn(Bb, S, H, P, **kw)
    gs = torch.randn(Bb, H, P, N, **kw)
    for _ in range(3):
        sops.ssm_scan_bwd(x, dt, A, B, C, gy, gs)
    torch.cuda.synchronize()
    ranks, per = skernel.split_sequence_bwd(S)
    blocks = Bb * H * ranks
    buf = np.zeros(blocks * STAMPS, dtype=np.uint64)
    runtime.check(lib, skernel.NAME, lib.ssm_bwd_stamps(
        buf.ctypes.data_as(ctypes.c_void_p), blocks * STAMPS))
    t = buf.reshape(blocks, STAMPS).astype(np.int64)
    start = (t[:, 0] - t[:, 0].min()) / 1e3
    end = (t[:, 6] - t[:, 0].min()) / 1e3
    busy = max(int(((start <= u) & (end > u)).sum())
               for u in np.linspace(0.0, end.max(), 400))
    print(f"B {Bb} x S {S}, {H} heads, P {P}, N {N}: {blocks} blocks "
          f"(R {ranks}, {per} chunk(s) a rank), span {end.max():.1f} us, "
          f"at most {busy} blocks at once")
    print("  block starts, quantiles 0/25/50/75/100 %:",
          np.percentile(start, [0, 25, 50, 75, 100]).round(1), "us")
    print("  block durations, quantiles:",
          np.percentile(end - start, [0, 25, 50, 75, 100]).round(1), "us")
    for label, a, b in PHASES:
        d = (t[:, b] - t[:, a]) / 1e3
        print(f"  {label:>20s}: mean {d.mean():.2f} us, max {d.max():.2f}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phases.py needs a CUDA device")
    lib = build()
    runtime._libs[skernel.NAME] = lib   # the wrappers launch this build
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip())
    for Bb, S in ((2, 256), (1, 1024)):
        report(lib, Bb, S)


if __name__ == "__main__":
    main()
