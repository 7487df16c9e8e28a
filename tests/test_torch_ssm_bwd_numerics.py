"""The numerics the SSD scan backward kernel's design rests on, on the CPU.

`csrc/ssm_scan.cu`'s `ssd_bwd_mma` computes the gradient of the scan in
64-row chunks, one chunk a thread block, the chunks of one (batch, head)
one thread-block cluster, every product on the TF32 tensor cores in split
(3xTF32) precision. The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2); this file checks its
arithmetic without it. A plain PyTorch emulation, written here:

- the planner's ranks (`split_sequence_bwd`) cut the sequence into
  segments of whole chunks;
- per chunk: a = dt A; ca its inclusive cumsum, exp(la - ca_s) from the
  suffix sum of a past s, and exp(ca_t - ca_s) from the sum of a over (s,
  t] of each row s, never from a difference of two cumulative sums (which
  loses digits under strong decays);
- each rank's (G, la) and (D, la) of its segment from zero; across the
  cluster, the state before it from the earlier ranks' (G, la) and h0, and
  the gradient after it from the later ranks' (D, la) and gstate;
- within a rank, its chunks in reverse: the gradient after each carried
  back, the state before each recomputed from the rank's start;
- per chunk the products B.C^T and x.gy^T on and above the diagonal, K^T,
  M'^T and M^T from them in registers, u = K^T gy + (exp(la - ca) B)
  Gam^T, dB = (exp(la - ca) dt x) Gam + M'^T C, dC = (exp(ca) gy) h + M'
  B, every product on operands split into a TF32 high part (rounded to
  nearest by bits) and the exact residual (read truncated to TF32), lo.hi
  + hi.lo + hi.hi in float32;
- rho from M^T by rectangle sums (each row's suffix over t >= s, then the
  rows r < s), the state terms by a suffix and an exclusive prefix sum of
  row dots, exp(la) <Gam, h>;
- dB and dC summed over the heads, dA over the batch and the tokens.

It agrees within 2e-5 of each gradient's largest magnitude (the card's gate
for #9b, tests/test_torch_cuda.py; at least 1 % of the largest magnitude
among the call's gradients, so that a gradient zero in exact arithmetic is
measured against that) with `jax.vjp` of the JAX package's
`ssd_chunked_ref` and with the port's per-token `ssd_bwd_ref`: at zamba2's
heads (P = N = 64) over 256 tokens and at 1,000 tokens, at S of 1, 63, 65
and 129, at P 4 with N 8, with h0 and no gstate, under strong decays (A
down to -80, dt up to 1), and on segments of more than two chunks. The same
emulation with operands rounded once to TF32 misses that gate at zamba2's
width: why the kernel pays for three MMAs a tile. `ref.ssd_bwd_chunked_ref`
(the chunked form in plain float32) is held to the same references.
Inputs come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.ssm_scan import ref as jssm_ref
from repro_torch.kernels.ssm_scan import ref as sref
from repro_torch.kernels.ssm_scan.kernel import (CHUNK, MAX_RANKS,
                                                 split_sequence_bwd)

GRAD_TOL = 2e-5
# the JAX reference's chunk under strong decays (see _jax_chunk)
STRONG_REF_CHUNK = 4


def _tf32(t):
    """t rounded to TF32 as the kernel's split rounds it: 10 mantissa
    bits, to nearest, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(t):
    """t as the tensor core reads a float32 operand: its low 13 bits
    dropped."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernel's MMAs take it: operands rounded once to TF32
    (passes = 1), or split into hi + lo with lo.hi + hi.lo + hi.hi
    (passes = 3); float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _trunc(a - ah), _trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chunks(t, ranks, per):
    """(Bb, S, ...) -> (Bb, ranks, per, CHUNK, ...), zeros past S."""
    Bb, S = t.shape[:2]
    out = t.new_zeros((Bb, ranks * per * CHUNK) + t.shape[2:])
    out[:, :S] = t
    return out.reshape((Bb, ranks, per, CHUNK) + t.shape[2:])


def _vectors(dt, A):
    """A chunk's decay terms from its (..., L, H) dt: exp(ca_t), exp(la -
    ca_s) (the suffix sum of a past s), exp(la), the (..., H, s, t)
    factors exp(ca_t - ca_s) for t >= s (zero below), each exponent a sum
    of the a's it spans, and la."""
    a = dt * A
    ca = torch.cumsum(a, dim=-2)
    past = torch.cat([torch.flip(torch.cumsum(torch.flip(a[..., 1:, :],
                                                         (-2,)), -2), (-2,)),
                      torch.zeros_like(a[..., :1, :])], -2)
    L = a.shape[-2]
    idx = torch.arange(L)
    after = idx[None, :] > idx[:, None]                  # (s, t): t > s
    seg = torch.cumsum(a.movedim(-1, -2)[..., None, :]
                       * after, dim=-1)                  # (..., H, s, t)
    keep = idx[None, :] >= idx[:, None]
    E = torch.where(keep, torch.exp(seg), torch.zeros(()))
    return torch.exp(ca), torch.exp(past), torch.exp(ca[..., -1, :]), E, \
        ca[..., -1, :]


def _state_product(w, v, m, passes):
    """sum over the chunk's rows of (w v)^T m: w (Bb,L,H) row weights, v
    (Bb,L,H,P), m (Bb,L,N) -> (Bb,H,P,N)."""
    a = (w[..., None] * v).permute(0, 2, 3, 1)           # (Bb,H,P,L)
    return _mm(a, m[:, None], passes)


def _emulate(x, dt, A, B, C, gy, gs, h0, passes=3):
    """The kernel's arithmetic on (Bb,S,H,P) x and gy, (Bb,S,H) dt, (H,) A,
    (Bb,S,N) B and C, optional (Bb,H,P,N) gstate and h0. -> (dx, ddt, dA,
    dB, dC, ranks, per)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    ranks, per = split_sequence_bwd(S)
    if S == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(B),
                torch.zeros_like(C), ranks, per)
    xc, gyc, dtc, Bc, Cc = (_chunks(t, ranks, per) for t in (x, gy, dt, B,
                                                             C))
    zero = x.new_zeros((Bb, H, P, N))

    def chunk(r, k):
        ea, eb, el, E, la = _vectors(dtc[:, r, k], A)
        return (xc[:, r, k], gyc[:, r, k], dtc[:, r, k], Bc[:, r, k],
                Cc[:, r, k], ea, eb, el, E, la)

    def G_of(r, k):
        xs, _, d, Bs, _, _, eb, el, _, _ = chunk(r, k)
        return el, _state_product(eb * d, xs, Bs, passes)

    def D_of(r, k, scale):
        _, g, _, _, Cs, ea, _, el, _, la = chunk(r, k)
        return el, _state_product(ea * scale[:, None], g, Cs, passes)

    # each rank's segment from zero: (G, D, la)
    segs = []
    for r in range(ranks):
        g_seg, d_seg, l_seg = zero, zero, x.new_zeros((Bb, H))
        for k in range(per):
            el, G = G_of(r, k)
            _, D = D_of(r, k, torch.exp(l_seg))
            g_seg = el[..., None, None] * g_seg + G
            d_seg = d_seg + D
            l_seg = l_seg + chunk(r, k)[-1]
        segs.append((g_seg, d_seg, l_seg))

    dx = torch.zeros_like(xc)
    ddt = torch.zeros_like(dtc)
    dBp = x.new_zeros((Bb, ranks, per, CHUNK, H, N))
    dCp = torch.zeros_like(dBp)
    dA_part = x.new_zeros((Bb, H, ranks))
    for r in range(ranks):
        # the cluster exchange: h before the segment, Gam after it
        h_in = zero if h0 is None else h0
        for q in range(r):
            g_q, _, l_q = segs[q]
            h_in = torch.exp(l_q)[..., None, None] * h_in + g_q
        gam = zero if gs is None else gs
        for q in range(ranks - 1, r, -1):
            _, d_q, l_q = segs[q]
            gam = torch.exp(l_q)[..., None, None] * gam + d_q
        dA_r = x.new_zeros((Bb, H))
        for k in range(per - 1, -1, -1):
            h = h_in
            for j in range(k):
                el, G = G_of(r, j)
                h = el[..., None, None] * h + G
            xs, g, d, Bs, Cs, ea, eb, el, E, _ = chunk(r, k)
            # s-major causal products and their registers
            bc = _mm(Bs, Cs.transpose(-1, -2), passes)[:, None]  # (Bb,1,s,t)
            xg = _mm(xs.movedim(2, 1), gyc[:, r, k].permute(0, 2, 3, 1),
                     passes)                                     # (Bb,H,s,t)
            ds = d.movedim(-1, 1)[..., None]                      # (Bb,H,s,1)
            KT = bc * E
            MpT = xg * E * ds
            MT = KT * xg * ds
            # u, dx and x . u
            u = (_mm(KT, g.movedim(2, 1), passes)
                 + _mm(eb.movedim(-1, 1)[..., None] * Bs[:, None],
                       gam.transpose(-1, -2), passes))
            xsh = xs.movedim(2, 1)                               # (Bb,H,L,P)
            xu = (xsh * u).sum(-1)
            dx[:, r, k] = (ds * u).movedim(1, 2)
            # dB: the state part, its row dot with B, then M'^T C
            dBs = _mm((eb * d).movedim(-1, 1)[..., None] * xsh, gam, passes)
            w3 = (dBs * Bs[:, None]).sum(-1)
            dB = dBs + _mm(MpT, Cs[:, None], passes)
            # dC: the state part, its row dot with C, then M' B
            dCs = _mm(ea.movedim(-1, 1)[..., None] * g.movedim(2, 1), h,
                      passes)
            w2 = (dCs * Cs[:, None]).sum(-1)
            dC = dCs + _mm(MpT.transpose(-1, -2), Bs[:, None], passes)
            dBp[:, r, k] = dB.movedim(1, 2)
            dCp[:, r, k] = dC.movedim(1, 2)
            # rho: the rectangle of M, the state terms, exp(la) <Gam, h>
            suffix = torch.flip(torch.cumsum(torch.flip(MT, (-1,)), -1),
                                (-1,))                     # sum over t >= s
            idx = torch.arange(CHUNK)
            below = idx[:, None] < idx[None, :]            # (r, s): r < s
            t1 = (suffix * below).sum(-2)
            t2 = torch.flip(torch.cumsum(torch.flip(w2, (-1,)), -1), (-1,))
            t3 = torch.cumsum(torch.nn.functional.pad(w3[..., :-1], (1, 0)),
                              -1)
            t4 = el * (gam * h).sum((-1, -2))
            rho = t1 + t2 + t3 + t4[..., None]             # (Bb,H,L)
            ddt[:, r, k] = (xu + A[:, None] * rho).movedim(1, 2)
            dA_r = dA_r + (ds[..., 0] * rho).sum(-1)
            # the gradient after the chunk before
            el_k, D = D_of(r, k, torch.ones((Bb, H)))
            gam = el_k[..., None, None] * gam + D
        dA_part[:, :, r] = dA_r

    def rows(t):
        return t.reshape((Bb, ranks * per * CHUNK) + t.shape[4:])[:, :S]

    dB = rows(dBp).sum(2)                                  # heads in order
    dC = rows(dCp).sum(2)
    dA = dA_part.sum((0, 2))
    return rows(dx), rows(ddt), dA, dB, dC, ranks, per


def _inputs(rng, Bb, S, H, P, N, initial=False, gstate=True, strong=False):
    """tests/test_kernels.py's law (dt = softplus(randn) * 0.1, A =
    -exp(randn), B and C at 0.3 scale), or strong decays: A uniform in
    [-80, -1], dt uniform in [0, 1]; gy and gstate standard normal."""
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
    gy = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    gs = (rng.standard_normal((Bb, H, P, N)).astype(np.float32)
          if gstate else None)
    return x, dt, A, B, C, gy, gs, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_grads(x, dt, A, B, C, gy, gs, h0, chunk=CHUNK):
    """jax.vjp of the JAX package's chunked scan at `chunk`-row chunks
    (halved until they divide S) with h0 a constant start; a None gstate is
    a zero cotangent."""
    def f(*args):
        return jssm_ref.ssd_chunked_ref(*args, chunk=chunk,
                                        initial_state=_j(h0))
    (y, h), vjp = jax.vjp(f, *map(_j, (x, dt, A, B, C)))
    cot = (jnp.asarray(gy),
           jnp.zeros_like(h) if gs is None else jnp.asarray(gs))
    return [torch.from_numpy(np.array(g)) for g in vjp(cot)]


def _jax_chunk(strong):
    """The JAX reference's chunk: the kernel's 64 rows, or 4 under strong
    decays, where its exp of a difference of two cumulative sums over 64
    rows lies 1e-4 from the exact gradient in float32
    (test_strong_decays_need_short_reference_chunks)."""
    return STRONG_REF_CHUNK if strong else CHUNK


def _rel(got, want, floor=1e-30):
    scale = want.float().abs().max().clamp_min(floor)
    return float((got.float() - want.float()).abs().max() / scale)


def _floor(grads):
    return 1e-2 * max(float(g.float().abs().max()) for g in grads)


def _check(got, want, what):
    floor = _floor(want)
    errs = {}
    for name, a, b in zip("dx ddt dA dB dC".split(), got, want):
        assert a.shape == b.shape, (what, name)
        assert torch.isfinite(a).all(), (what, name)
        errs[name] = _rel(a, b, floor)
    assert max(errs.values()) <= GRAD_TOL, (what, errs)
    return errs


# (Bb, S, H, P, N, initial, gstate, strong, (ranks, chunks a rank))
CASES = {
    "zamba2 heads, S 256": (2, 256, 4, 64, 64, False, True, False, (4, 1)),
    "zamba2 heads, S 1000": (1, 1000, 2, 64, 64, True, True, False, (8, 2)),
    "S 1": (2, 1, 3, 16, 32, False, True, False, (1, 1)),
    "S 63": (2, 63, 3, 16, 32, True, True, False, (1, 1)),
    "S 65": (2, 65, 3, 16, 32, False, True, False, (2, 1)),
    "S 129": (2, 129, 3, 16, 32, True, True, False, (3, 1)),
    "P 4, N 8": (2, 300, 3, 4, 8, False, True, False, (5, 1)),
    "h0, no gstate": (2, 200, 3, 16, 16, True, False, False, (4, 1)),
    "strong decays": (1, 512, 4, 32, 32, True, True, True, (8, 1)),
    "strong decays, S 130": (2, 130, 4, 16, 8, False, True, True, (3, 1)),
    "segments of 4 chunks": (1, 1600, 2, 8, 8, True, True, False, (7, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_jax_vjp_and_the_per_token_backward(case):
    Bb, S, H, P, N, initial, gstate, strong, plan = CASES[case]
    rng = np.random.default_rng([S, H, P, N, int(initial), int(strong)])
    arrays = _inputs(rng, Bb, S, H, P, N, initial, gstate, strong)
    x, dt, A, B, C, gy, gs, h0 = map(_t, arrays)
    *got, ranks, per = _emulate(x, dt, A, B, C, gy, gs, h0)
    assert (ranks, per) == plan
    _check(got, _jax_grads(*arrays, chunk=_jax_chunk(strong)),
           f"{case} vs jax.vjp")
    _check(got, sref.ssd_bwd_ref(x, dt, A, B, C, gy, gs, h0),
           f"{case} vs ssd_bwd_ref")


@pytest.mark.parametrize("case", ["zamba2 heads, S 256", "S 129",
                                  "h0, no gstate", "strong decays",
                                  "segments of 4 chunks"])
def test_chunked_ref_matches_jax_vjp_and_the_per_token_backward(case):
    Bb, S, H, P, N, initial, gstate, strong, _ = CASES[case]
    rng = np.random.default_rng([S, H, P, N, int(initial), int(strong)])
    arrays = _inputs(rng, Bb, S, H, P, N, initial, gstate, strong)
    x, dt, A, B, C, gy, gs, h0 = map(_t, arrays)
    got = sref.ssd_bwd_chunked_ref(x, dt, A, B, C, gy, gs, h0)
    _check(got, _jax_grads(*arrays, chunk=_jax_chunk(strong)),
           f"{case} vs jax.vjp")
    _check(got, sref.ssd_bwd_ref(x, dt, A, B, C, gy, gs, h0),
           f"{case} vs ssd_bwd_ref")


def test_one_tf32_pass_misses_the_gate_three_hold_it():
    """At zamba2's width (P = N = 64, 256 tokens) operands rounded once to
    TF32 land outside 2e-5 of the per-token backward; split into hi + lo
    they land well inside it."""
    rng = np.random.default_rng(2026)
    x, dt, A, B, C, gy, gs, h0 = map(_t, _inputs(rng, 2, 256, 4, 64, 64))
    want = sref.ssd_bwd_ref(x, dt, A, B, C, gy, gs, h0)
    floor = _floor(want)
    three = _emulate(x, dt, A, B, C, gy, gs, h0, passes=3)[:5]
    one = _emulate(x, dt, A, B, C, gy, gs, h0, passes=1)[:5]
    worst3 = max(_rel(a, b, floor) for a, b in zip(three, want))
    worst1 = max(_rel(a, b, floor) for a, b in zip(one, want))
    assert worst3 <= GRAD_TOL / 4, worst3
    assert worst1 > GRAD_TOL, worst1


@pytest.mark.parametrize("S,plan", [(0, (1, 0)), (1, (1, 1)), (64, (1, 1)),
                                    (65, (2, 1)), (256, (4, 1)),
                                    (512, (8, 1)), (513, (5, 2)),
                                    (1024, (8, 2)), (2048, (8, 4))])
def test_the_backward_planner(S, plan):
    """One chunk a rank up to MAX_RANKS chunks, then the fewest chunks a
    rank; every rank has rows and the last holds the end."""
    assert split_sequence_bwd(S) == plan
    ranks, per = plan
    assert 1 <= ranks <= MAX_RANKS
    if S:
        assert (ranks - 1) * per * CHUNK < S <= ranks * per * CHUNK


def test_strong_decays_need_short_reference_chunks():
    """Under strong decays (A down to -80, dt up to 1) the chunked JAX
    reference at 64-row chunks forms exp(ca_t - ca_s) from two cumulative
    sums of up to a few thousand, and its float32 gradient lands outside
    2e-5 of the per-token one (`jax.vjp` of `ssd_sequential_ref`); at
    4-row chunks it lands well inside, and so does the emulation, which
    sums each exponent over the rows it spans."""
    Bb, S, H, P, N, initial, gstate, strong, _ = CASES["strong decays"]
    rng = np.random.default_rng([S, H, P, N, int(initial), int(strong)])
    arrays = _inputs(rng, Bb, S, H, P, N, initial, gstate, strong)
    x, dt, A, B, C, gy, gs, h0 = arrays

    def f(*args):
        return jssm_ref.ssd_sequential_ref(*args, initial_state=_j(h0))
    _, vjp = jax.vjp(f, *map(_j, (x, dt, A, B, C)))
    exact = [torch.from_numpy(np.array(g))
             for g in vjp((jnp.asarray(gy), jnp.asarray(gs)))]
    floor = _floor(exact)

    def worst(got):
        return max(_rel(a, b, floor) for a, b in zip(got, exact))
    assert worst(_jax_grads(*arrays, chunk=CHUNK)) > GRAD_TOL
    assert worst(_jax_grads(*arrays, chunk=STRONG_REF_CHUNK)) < GRAD_TOL / 4
    assert worst(_emulate(*map(_t, arrays))[:5]) < GRAD_TOL / 10
