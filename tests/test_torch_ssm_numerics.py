"""The numerics the SSD scan kernel's design rests on, on the CPU.

`csrc/ssm_scan.cu`'s `ssd_kernel_mma` splits the sequence of each (batch,
head) over the thread blocks of one cluster and runs its products on TF32
tensor cores in split (3xTF32) precision. The kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 2); this file checks
its arithmetic without it. A plain PyTorch emulation, written here:

- the planner's ranks (`split_sequence`) cut the sequence into segments of
  whole 64-row chunks;
- each rank walks its segment in super-chunks of two chunks from a zero
  state: per chunk the cumulative log decay ca, C.B^T, W = (C.B^T)
  exp(ca_t - ca_s) dt_s on and below the diagonal, W.x, and the chunk's
  state G = (u x)^T B with u_s = exp(ca_end - ca_s) dt_s; a super-chunk's
  G_T = exp(la_1) G_0 + G_1;
- each rank's starting state from the earlier ranks' (G, la) and h0,
  h_in = D_{r-1}(...(D_0 h0 + G_0)...) + G_{r-1};
- each chunk's rows then gain exp(ca_t) C_t . h_c (h_0 the super-chunk's
  starting state, h_1 = exp(la_0) h_0 + G_0);
- every product on operands split into a TF32 high part (rounded to
  nearest by bits, as cvt.rna rounds) and the exact residual, which the
  tensor core reads truncated to TF32; lo.hi + hi.lo + hi.hi in float32.

It agrees at rtol = atol = 1e-4 (the JAX package's tolerance for its SSD
kernel) with the JAX package's `ssm_scan` (its Pallas kernel in interpret
mode, which folds an initial state in after a zero-state scan) and with its
literal per-token scan `ssd_sequential_ref`: at zamba2's heads (P = N = 64)
over 1,024 tokens, at S of 1, 63, 65, 129 and 1,000 (segment and chunk
edges mid-tile), at P = 4 and N = 8, with an initial state crossing ranks,
with strong decays (A down to -80, dt up to 1: exp(ca) underflows in late
ranks), and on both long-segment walks (R > 1 with three chunks a rank; R =
1 over a card the batch fills). The same emulation with operands rounded
once to TF32 misses that tolerance at zamba2's width: why the kernel pays
for three MMAs a tile. Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.ssm_scan import ops as jssm
from repro.kernels.ssm_scan import ref as jssm_ref
from repro_torch.kernels.ssm_scan.kernel import (CHUNK, KEEP_CHUNKS,
                                                 MAX_RANKS, split_sequence)

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# blocks an H100 holds at once: 132 SMs, two blocks of 106,000 bytes of
# shared memory each
H100_BLOCKS = 264
SUPER = KEEP_CHUNKS * CHUNK


def _tf32(t):
    """t rounded to TF32 as the kernel's split rounds it (and cvt.rna): 10
    mantissa bits, to nearest, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(t):
    """t as the tensor core reads a float32 operand: its low 13 bits
    dropped."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernel's MMAs take it: operands rounded once to TF32
    (passes = 1), or split into hi (rounded) + lo (the exact rest, read
    truncated) with lo.hi + hi.lo + hi.hi (passes = 3); float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _trunc(a - ah), _trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _segments(t, ranks, per, nsup):
    """(Bb, S, ...) -> (Bb, ranks, nsup, KEEP_CHUNKS, CHUNK, ...): each
    rank's rows in its super-chunks, zeros past its segment."""
    Bb, S = t.shape[:2]
    out = t.new_zeros((Bb, ranks, nsup * SUPER) + t.shape[2:])
    for r in range(ranks):
        r0 = r * per * CHUNK
        r1 = min(S, r0 + per * CHUNK)
        out[:, r, :r1 - r0] = t[:, r0:r1]
    return out.reshape((Bb, ranks, nsup, KEEP_CHUNKS, CHUNK) + t.shape[2:])


def _emulate(x, dt, A, B, C, h0, slots, passes=3):
    """The kernel's arithmetic on (Bb,S,H,P) x, (Bb,S,H) dt, (H,) A, (Bb,S,N)
    B and C, an optional (Bb,H,P,N) h0, split as the planner splits it for
    a card that holds `slots` blocks. -> (y, final state, ranks)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    ranks, per = split_sequence(Bb, H, S, slots)
    nsup = -(-per // KEEP_CHUNKS)
    xc, dtc, Bc, Cc = (_segments(t, ranks, per, nsup) for t in (x, dt, B, C))
    # per chunk, from a zero state
    ca = torch.cumsum(dtc * A, dim=4)                    # (..., L, H)
    la = ca[..., -1, :]                                  # (..., H)
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    gap = torch.where(tri[..., None],
                      ca[..., :, None, :] - ca[..., None, :, :],
                      float("-inf"))                     # (..., t, s, H)
    cb = _mm(Cc, Bc.transpose(-1, -2), passes)           # (..., t, s)
    w = cb[..., None] * torch.exp(gap) * dtc[..., None, :, :]
    y = _mm(w.movedim(-1, -3), xc.movedim(-2, -3), passes)   # (..., H, L, P)
    u = torch.exp(la[..., None, :] - ca) * dtc           # (..., L, H)
    ux = (u[..., None] * xc).movedim(-3, -1)             # (..., H, P, L)
    G = _mm(ux, Bc[..., None, :, :], passes)             # (..., H, P, N)
    # super-chunks: G_T = exp(la_1) G_0 + G_1
    GT = torch.exp(la[:, :, :, 1])[..., None, None] * G[:, :, :, 0] \
        + G[:, :, :, 1]                                  # (Bb,R,K,H,P,N)
    laT = la[:, :, :, 0] + la[:, :, :, 1]                # (Bb,R,K,H)
    # each segment's (G, la) from a zero state
    gseg = x.new_zeros((Bb, ranks, H, P, N))
    laseg = x.new_zeros((Bb, ranks, H))
    for s in range(nsup):
        gseg = torch.exp(laT[:, :, s])[..., None, None] * gseg + GT[:, :, s]
        laseg = laseg + laT[:, :, s]
    zero = x.new_zeros((Bb, H, P, N))
    out = torch.zeros_like(y)
    for r in range(ranks):
        h = zero if h0 is None else h0
        for q in range(r):
            h = torch.exp(laseg[:, q])[..., None, None] * h + gseg[:, q]
        for s in range(nsup):
            starts = (h, torch.exp(la[:, r, s, 0])[..., None, None] * h
                      + G[:, r, s, 0])
            for c, hc in enumerate(starts):
                scaled = torch.exp(ca[:, r, s, c]).movedim(-1, 1)[..., None] \
                    * Cc[:, r, s, c][:, None]            # (Bb, H, L, N)
                out[:, r, s, c] = y[:, r, s, c] + _mm(
                    scaled, hc.transpose(-1, -2), passes)
            h = torch.exp(laT[:, r, s])[..., None, None] * h + GT[:, r, s]
    # (Bb, R, K, 2, H, L, P) -> (Bb, S, H, P)
    rows = out.movedim(4, 5).reshape(Bb, ranks, nsup * SUPER, H, P)
    y_full = torch.cat([rows[:, r, :min(S, (r + 1) * per * CHUNK)
                             - r * per * CHUNK] for r in range(ranks)], 1)
    return y_full, h, ranks


def _inputs(rng, Bb, S, H, P, N, initial=False, strong=False):
    """tests/test_kernels.py's law (dt = softplus(randn) * 0.1, A =
    -exp(randn), B and C at 0.3 scale), or strong decays: A uniform in
    [-80, -1], dt uniform in [0, 1]."""
    x = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    if strong:
        dt = rng.uniform(0.0, 1.0, (Bb, S, H)).astype(np.float32)
        A = (-rng.uniform(1.0, 80.0, H)).astype(np.float32)
    else:
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


# (Bb, S, H, P, N, initial, strong, slots, ranks the planner gives)
CASES = {
    "zamba2 heads, S 1024": (1, 1024, 8, 64, 64, False, False, H100_BLOCKS, 8),
    "S 1": (2, 1, 3, 16, 32, False, False, H100_BLOCKS, 1),
    "S 63": (2, 63, 3, 16, 32, False, False, H100_BLOCKS, 1),
    "S 65": (2, 65, 3, 16, 32, False, False, H100_BLOCKS, 1),
    "S 129": (2, 129, 3, 16, 32, False, False, H100_BLOCKS, 2),
    "S 1000": (1, 1000, 3, 16, 32, False, False, H100_BLOCKS, 8),
    "P 4, N 8": (2, 300, 3, 4, 8, False, False, H100_BLOCKS, 3),
    "initial state across ranks": (2, 300, 4, 16, 16, True, False,
                                   H100_BLOCKS, 3),
    "strong decays": (1, 512, 4, 32, 32, True, True, H100_BLOCKS, 4),
    "long segments, R 8": (1, 1500, 2, 16, 16, True, False, H100_BLOCKS, 8),
    "long segment, R 1": (2, 300, 2, 16, 16, True, False, 4, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_the_jax_scan(case):
    Bb, S, H, P, N, initial, strong, slots, want_ranks = CASES[case]
    rng = np.random.default_rng([S, H, P, N, int(initial), int(strong)])
    x, dt, A, B, C, h0 = _inputs(rng, Bb, S, H, P, N, initial, strong)
    y, h, ranks = _emulate(*map(_t, (x, dt, A, B, C, h0)), slots)
    assert ranks == want_ranks
    assert y.shape == (Bb, S, H, P) and h.shape == (Bb, H, P, N)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    # the Pallas kernel at the kernel's 64-row chunks (halved until they
    # divide S): the function does not depend on the chunk, but an exp of
    # a difference of two cumulative sums loses digits with the sums'
    # length (under the strong decays one 512-row chunk is 3.3e-4 off the
    # per-token scan)
    jy, jh = jssm.ssm_scan(*map(_j, (x, dt, A, B, C)), chunk=CHUNK,
                           initial_state=_j(h0), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    sy, sh = jssm_ref.ssd_sequential_ref(*map(_j, (x, dt, A, B, C)),
                                         initial_state=_j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(sy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(sh), **SCAN_TOL)


def test_one_tf32_pass_misses_the_tolerance_three_hold_it():
    """At zamba2's width (P = N = 64, 1,024 tokens) operands rounded once
    to TF32 land about ten times outside rtol = atol = 1e-4 of the per-token
    scan; split into hi + lo they land well inside it."""
    rng = np.random.default_rng(2024)
    x, dt, A, B, C, _ = map(_t, _inputs(rng, 1, 1024, 8, 64, 64))
    jy, jh = (torch.from_numpy(np.array(v)) for v in
              jssm_ref.ssd_sequential_ref(*(jnp.asarray(t.numpy())
                                            for t in (x, dt, A, B, C))))
    y3, h3, _ = _emulate(x, dt, A, B, C, None, H100_BLOCKS, passes=3)
    y1, h1, _ = _emulate(x, dt, A, B, C, None, H100_BLOCKS, passes=1)
    torch.testing.assert_close(y3, jy, **SCAN_TOL)
    torch.testing.assert_close(h3, jh, **SCAN_TOL)
    assert (y3 - jy).abs().max() < 1e-5
    assert not torch.allclose(y1, jy, **SCAN_TOL)
    assert (y1 - jy).abs().max() > 3e-4


def test_the_planner_at_zamba2s_shapes():
    """zamba2's batch-1 prefill splits (R = 8 at 1,024 tokens, R = 2 at
    256); a batch of 4 x 80 heads already fills the card (R = 1)."""
    assert split_sequence(1, 80, 1024, H100_BLOCKS) == (8, 2)
    assert split_sequence(1, 80, 256, H100_BLOCKS) == (2, 2)
    assert split_sequence(4, 80, 256, H100_BLOCKS) == (1, 4)
    assert split_sequence(1, 80, 0, H100_BLOCKS) == (1, 0)


@pytest.mark.parametrize("BbH,slots", [(1, 264), (80, 264), (263, 264),
                                       (264, 264), (6, 1)])
def test_the_planner_covers_every_row(BbH, slots):
    """Every rank has rows, the last holds the end, at most MAX_RANKS; a
    split segment has at most KEEP_CHUNKS chunks up to MAX_RANKS of them;
    one rank where Bb * H fills the card."""
    for S in list(range(1, 300)) + [511, 512, 513, 1000, 1024, 1025, 4000]:
        ranks, per = split_sequence(1, BbH, S, slots)
        chunks = -(-S // CHUNK)
        assert 1 <= ranks <= MAX_RANKS
        assert (ranks - 1) * per * CHUNK < S <= ranks * per * CHUNK
        if BbH >= slots:
            assert ranks == 1
        elif chunks <= KEEP_CHUNKS * MAX_RANKS:
            assert per <= KEEP_CHUNKS
