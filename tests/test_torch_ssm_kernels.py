"""The port's SSD-scan and RMSNorm wrappers on CPU tensors (their plain
versions) against the JAX package: `ssm_scan` against the JAX `ssm_scan`
(its Pallas kernel in interpret mode, which folds an initial state in after
a zero-state scan) and against the literal per-token scan
`ssd_sequential_ref`, on the case families of tests/test_kernels.py plus a
ragged S (37: the chunk halves to one 37-row chunk; 100: to 4 rows) and an
initial state; `rmsnorm` against the JAX RMSNorm kernel in interpret mode.
Also: both kernel modules import without nvcc or triton, a CPU tensor
counts no launch, and the CUDA wrappers check their arguments before
anything is built.

Tolerances: the scan at rtol = atol = 1e-4, the JAX package's own for its
SSD kernel (tests/test_kernels.py::test_ssm_scan_vs_sequential: sums of up
to a chunk of terms in another order, and exps of cumulative sums);
RMSNorm in float32 at rtol = atol = 1e-6 (one rsqrt and a mean in another
order), in bfloat16 at one bf16 step (2 ** -7) relative, where both sides
round the same float32 value and may land on neighbouring steps."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.rmsnorm import ops as jrms
from repro.kernels.ssm_scan import ops as jssm
from repro.kernels.ssm_scan import ref as jssm_ref
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.ssm_scan import kernel as skernel
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan import ref as sref

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


def _scan_inputs(rng, Bb, S, H, P, N, initial=False):
    """tests/test_kernels.py's law: dt = softplus(randn) * 0.1, A =
    -exp(randn), B and C at 0.3 scale."""
    x = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bb, S, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((Bb, H, P, N)).astype(np.float32)
          if initial else None)
    return x, dt, A, B, C, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (Bb, S, H, P, N, chunk): tests/test_kernels.py's three cases, then a
# ragged S of 37 and of 100, TINY_EDGE_C's heads (H 4, P 64, N 16, chunk
# 64) and an initial state
CASES = [(2, 64, 3, 8, 16, 16, False), (1, 128, 2, 16, 32, 32, False),
         (2, 96, 1, 4, 8, 32, False), (1, 37, 2, 8, 16, 64, False),
         (2, 100, 2, 8, 8, 32, False), (1, 48, 4, 64, 16, 64, False),
         (2, 32, 2, 4, 8, 16, True), (1, 37, 3, 8, 16, 64, True)]


@pytest.mark.parametrize("Bb,S,H,P,N,chunk,initial", CASES)
def test_ssm_scan_matches_jax(Bb, S, H, P, N, chunk, initial):
    rng = np.random.default_rng(S * 7 + H)
    x, dt, A, B, C, h0 = _scan_inputs(rng, Bb, S, H, P, N, initial)
    before = sops.ssm_scan.launches
    y, h = sops.ssm_scan(*map(_t, (x, dt, A, B, C)), chunk=chunk,
                         initial_state=_t(h0))
    assert sops.ssm_scan.launches == before      # the plain version
    assert y.dtype == h.dtype == torch.float32
    jy, jh = jssm.ssm_scan(*map(_j, (x, dt, A, B, C)), chunk=chunk,
                           initial_state=_j(h0), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    sy, sh = jssm_ref.ssd_sequential_ref(*map(_j, (x, dt, A, B, C)),
                                         initial_state=_j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(sy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(sh), **SCAN_TOL)


@pytest.mark.parametrize("initial", [False, True])
def test_port_sequential_scan_matches_jax(initial):
    """The port's literal per-token scan, the ground truth of its own
    tests, against the JAX package's."""
    rng = np.random.default_rng(11)
    x, dt, A, B, C, h0 = _scan_inputs(rng, 2, 40, 3, 8, 16, initial)
    y, h = sref.ssd_sequential_ref(*map(_t, (x, dt, A, B, C)),
                                   initial_state=_t(h0))
    jy, jh = jssm_ref.ssd_sequential_ref(*map(_j, (x, dt, A, B, C)),
                                         initial_state=_j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


def test_initial_state_equals_a_split_scan():
    """Scanning S tokens equals scanning the first part, then the rest from
    its final state: what a Mamba2 layer relies on across calls."""
    rng = np.random.default_rng(12)
    x, dt, A, B, C, _ = map(_t, _scan_inputs(rng, 2, 50, 2, 8, 16))
    y, h = sops.ssm_scan(x, dt, A, B, C, chunk=16)
    y1, h1 = sops.ssm_scan(x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20],
                           chunk=16)
    y2, h2 = sops.ssm_scan(x[:, 20:], dt[:, 20:], A, B[:, 20:], C[:, 20:],
                           chunk=16, initial_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
    torch.testing.assert_close(h2, h, **SCAN_TOL)


@pytest.mark.parametrize("S,chunk,Q", [(64, 16, 16), (37, 64, 37),
                                       (1000, 256, 8), (96, 32, 32),
                                       (5, 256, 5)])
def test_chunk_len_halves_as_jax(S, chunk, Q):
    assert sref.chunk_len(S, chunk) == Q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(3, 96), (10, 128), (5, 1536)])
def test_rmsnorm_matches_jax(dtype, R, D):
    rng = np.random.default_rng(R + D)
    x = rng.standard_normal((R, D)).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    before = rops.rmsnorm.launches
    got = rops.rmsnorm(tx, torch.from_numpy(scale), 1e-6)
    assert rops.rmsnorm.launches == before and got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jrms.rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                        eps=1e-6, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)


def test_rmsnorm_keeps_leading_dims():
    x = torch.randn(2, 3, 8)
    out = rops.rmsnorm(x, torch.ones(8))
    assert out.shape == x.shape
    torch.testing.assert_close(out[1, 2], rops.rmsnorm(x[1, 2], torch.ones(8)))


# ---------------------------------------------------------------------------
# imports and argument checks
# ---------------------------------------------------------------------------

def test_modules_import_without_nvcc_or_triton():
    code = ("import sys\n"
            "sys.modules['triton'] = None\n"
            "import repro_torch.kernels.ssm_scan.ops\n"
            "import repro_torch.kernels.rmsnorm.ops\n"
            "import repro_torch.models.ssm\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mixed_devices_are_refused():
    meta = torch.empty(1, 4, 2, 8, device="meta")
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        sops.ssm_scan(x, torch.zeros(1, 4, 2), torch.zeros(2),
                      torch.zeros(1, 4, 8), torch.zeros(1, 4, 8),
                      initial_state=meta)
    with pytest.raises(ValueError):
        rops.rmsnorm(torch.zeros(2, 8), torch.empty(8, device="meta"))


@pytest.mark.parametrize("bad", ["dtype", "P", "N", "shape", "initial"])
def test_scan_kernel_wrapper_checks_arguments(bad):
    """The CUDA wrapper raises on what the kernel does not take, before it
    loads or builds anything."""
    Bb, S, H, P, N = 1, 8, 2, 8, 16
    x, dt, A = torch.zeros(Bb, S, H, P), torch.zeros(Bb, S, H), torch.zeros(H)
    B = C = torch.zeros(Bb, S, N)
    h0 = None
    if bad == "dtype":
        x = x.bfloat16()
    elif bad == "P":
        x = torch.zeros(Bb, S, H, 66)
    elif bad == "N":
        B = C = torch.zeros(Bb, S, 6)
    elif bad == "shape":
        dt = torch.zeros(Bb, S + 1, H)
    else:
        h0 = torch.zeros(Bb, H, N, P)
    with pytest.raises(ValueError):
        skernel.ssm_scan_cuda(x, dt, A, B, C, h0)


@pytest.mark.parametrize("bad", ["dtype", "P", "N", "P 6", "N 10", "shape",
                                 "gy", "gstate", "initial"])
def test_scan_bwd_kernel_wrapper_checks_arguments(bad):
    """The backward's CUDA wrapper raises on what its kernel does not take
    (P and N multiples of 4 up to 64, as the forward), before it loads or
    builds anything."""
    Bb, S, H, P, N = 1, 8, 2, 8, 16
    x, dt, A = torch.zeros(Bb, S, H, P), torch.zeros(Bb, S, H), torch.zeros(H)
    B = C = torch.zeros(Bb, S, N)
    gy, gs, h0 = torch.zeros(Bb, S, H, P), None, None
    if bad == "dtype":
        x = x.bfloat16()
    elif bad == "P":
        x, gy = torch.zeros(Bb, S, H, 66), torch.zeros(Bb, S, H, 66)
    elif bad == "N":
        B = C = torch.zeros(Bb, S, 68)
    elif bad == "P 6":
        x, gy = torch.zeros(Bb, S, H, 6), torch.zeros(Bb, S, H, 6)
    elif bad == "N 10":
        B = C = torch.zeros(Bb, S, 10)
    elif bad == "shape":
        dt = torch.zeros(Bb, S + 1, H)
    elif bad == "gy":
        gy = torch.zeros(Bb, S, H, P + 4)
    elif bad == "gstate":
        gs = torch.zeros(Bb, H, N, P)
    else:
        h0 = torch.zeros(Bb, H, N, P)
    with pytest.raises(ValueError):
        skernel.ssm_scan_bwd_cuda(x, dt, A, B, C, gy, gs, h0)


@pytest.mark.parametrize("bad", ["dtype", "D", "scale", "contiguous"])
def test_rmsnorm_kernel_wrapper_checks_arguments(bad):
    x, scale = torch.zeros(4, 64), torch.ones(64)
    if bad == "dtype":
        x = x.half()
    elif bad == "D":
        x, scale = torch.zeros(4, 6, dtype=torch.bfloat16), torch.ones(6)
    elif bad == "scale":
        scale = torch.ones(32)
    else:
        x = torch.zeros(64, 4).T
    with pytest.raises(ValueError):
        rkernel.rmsnorm_cuda(x, scale)
