"""Plain PyTorch versions of the Mamba2 SSD scan, written as the JAX
package's oracle (`repro/kernels/ssm_scan/ref.py`) is.

Recurrence (per batch b, head h):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t (outer) x_t
    y_t = C_t^T h_t
with h in R^{P x N} (head_dim x state), B/C shared across heads (n_groups=1).

  ssd_sequential_ref — the literal per-token scan (ground truth for tests)
  ssd_chunked_ref    — the chunked parallel form (the models' plain path on
                       the CPU, and the CUDA kernel's plain version)
  ssd_bwd_ref        — the backward on the per-token recurrence (the
                       backward's plain path on the CPU)
  ssd_bwd_chunked_ref — the backward in 64-row chunks, as the backward
                       kernel computes it (its model; tests only)
"""
from __future__ import annotations

import torch


def _f32(*ts):
    return tuple(t.float() for t in ts)


def ssd_sequential_ref(x, dt, A, B, C, initial_state=None):
    """x: (Bb,S,H,P), dt: (Bb,S,H), A: (H,), B/C: (Bb,S,N).

    Returns y (Bb,S,H,P), final_state (Bb,H,P,N). All math in f32."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, A, B, C = _f32(x, dt, A, B, C)
    h = (x.new_zeros((Bb, H, P, N))
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None])                       # (Bb,H)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, None, None, :]
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def chunk_len(S: int, chunk: int) -> int:
    """The JAX package's chunk for S tokens: `chunk` (at most S), halved
    until it divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def ssd_chunked_ref(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """Chunked-parallel SSD. Same signature and semantics as
    `ssd_sequential_ref`."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    x, dt, A, B, C = _f32(x, dt, A, B, C)

    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)

    dA = dtc * A[None, None, None, :]                  # (Bb,nc,Q,H) log-decays
    ca = torch.cumsum(dA, dim=2)                       # inclusive cumsum
    ca_end = ca[:, :, -1:]                             # (Bb,nc,1,H)

    # intra-chunk: y[t] = sum_{s<=t} exp(ca_t - ca_s) dt_s (C_t.B_s) x_s
    decay = ca[:, :, :, None, :] - ca[:, :, None, :, :]   # (Bb,nc,Q,Q,H) t,s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], decay,
                              float("-inf")))
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)          # (Bb,nc,Q,Q)
    w = cb[..., None] * L * dtc[:, :, None, :, :]         # (Bb,nc,Q,Q,H)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w, xc)

    # chunk state contributions: G_c = sum_s exp(ca_end - ca_s) dt_s B_s x_s
    kdecay = torch.exp(ca_end - ca) * dtc                 # (Bb,nc,Q,H)
    G = torch.einsum("bcqh,bcqn,bcqhp->bchpn", kdecay, Bc, xc)

    # inter-chunk scan of states (the state BEFORE each chunk is kept)
    h = (x.new_zeros((Bb, H, P, N))
         if initial_state is None else initial_state.float())
    chunk_decay = torch.exp(ca_end[:, :, 0])              # (Bb,nc,H)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + G[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (Bb,nc,H,P,N)

    # state contribution within chunk: y_state[t] = exp(ca_t) C_t . h_prev
    qdecay = torch.exp(ca)
    y_state = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * qdecay[..., None]
    y = (y_intra + y_state).reshape(Bb, S, H, P)
    return y, h


def ssd_bwd_ref(x, dt, A, B, C, gy, gstate=None, initial_state=None):
    """The backward of the scan, written out on the per-token recurrence
    (`ssd_sequential_ref`), in float32. With a_t = exp(dt_t A) and G_t the
    gradient reaching h_t (G_S = gstate + gy_S C_S, G_t = a_{t+1} G_{t+1}
    + gy_t C_t):
      dx_t   = dt_t G_t B_t
      ddt_t  = x_t . (G_t B_t) + A a_t <G_t, h_{t-1}>
      dA     = sum_t dt_t a_t <G_t, h_{t-1}>    (summed over the batch)
      dB_t   = dt_t sum_h G_t^T x_t              (summed over the heads)
      dC_t   = sum_h h_t^T gy_t
    x, gy: (Bb,S,H,P); dt: (Bb,S,H); A: (H,); B/C: (Bb,S,N); gstate
    (Bb,H,P,N) or None (zero); initial_state h_{-1} or None (zero), taken
    as a constant. -> (dx, ddt, dA, dB, dC)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, A, B, C, gy = _f32(x, dt, A, B, C, gy)
    h = (x.new_zeros((Bb, H, P, N))
         if initial_state is None else initial_state.float())
    states = [h]
    decays = torch.exp(dt * A[None, None])                       # (Bb,S,H)
    for t in range(S):
        h = (h * decays[:, t, :, None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * B[:, t, None, None, :])
        states.append(h)
    G = (x.new_zeros((Bb, H, P, N)) if gstate is None
         else gstate.float().clone())
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    dA = x.new_zeros((H,))
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            G = G * decays[:, t + 1, :, None, None]
        G = G + gy[:, t, :, :, None] * C[:, t, None, None, :]
        u = torch.einsum("bhpn,bn->bhp", G, B[:, t])
        gh = (G * states[t]).sum(dim=(-1, -2))                     # (Bb,H)
        dx[:, t] = dt[:, t, :, None] * u
        ddt[:, t] = ((x[:, t] * u).sum(dim=-1)
                     + A[None] * decays[:, t] * gh)
        dA = dA + (dt[:, t] * decays[:, t] * gh).sum(dim=0)
        dB[:, t] = torch.einsum("bh,bhpn,bhp->bn", dt[:, t], G, x[:, t])
        dC[:, t] = torch.einsum("bhpn,bhp->bn", states[t + 1], gy[:, t])
    return dx, ddt, dA, dB, dC


def _exclusive_cumsum(t, dim):
    """sum over the entries before each one along `dim` (the first gets
    0), summed directly and not as a cumsum less the entry."""
    t = t.movedim(dim, -1)
    out = torch.cumsum(torch.nn.functional.pad(t[..., :-1], (1, 0)), dim=-1)
    return out.movedim(-1, dim)


def _suffix_cumsum(t, dim):
    """sum over each entry and the ones after it along `dim`."""
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))


def ssd_bwd_chunked_ref(x, dt, A, B, C, gy, gstate=None, initial_state=None,
                        chunk: int = 64):
    """The backward of the scan in chunks of `chunk` rows (S padded with
    zero rows), as `csrc/ssm_scan.cu`'s backward kernel computes it; the
    same function as `ssd_bwd_ref`. Per (b, h) and chunk c of rows t, with
    ca_t the inclusive cumsum of dt A from the chunk's start, la = ca at
    its last row, h_c the state before it and Gam_c the gradient reaching
    the state after it (Gam_last = gstate, Gam_{c-1} = exp(la_c) Gam_c +
    D_c, D_c = sum_t exp(ca_t) gy_t C_t^T):
      K_ts  = exp(ca_t - ca_s) (C_t . B_s)                  (s <= t)
      M'_ts = exp(ca_t - ca_s) dt_s (gy_t . x_s),  M = (C_t . B_s) M'
      u_s   = sum_t K_ts gy_t + exp(la - ca_s) Gam_c B_s,    dx_s = dt_s u_s
      dC_t  = sum_h [sum_s M'_ts B_s + exp(ca_t) h_c^T gy_t]
      dB_s  = sum_h [sum_t M'_ts C_t + exp(la - ca_s) dt_s Gam_c^T x_s]
      rho_s = sum_{t>=s} sum_{r<s} M_tr + sum_{t>=s} exp(ca_t) gy_t . h_c C_t
              + sum_{r<s} exp(la - ca_r) dt_r x_r . Gam_c B_r
              + exp(la) <Gam_c, h_c>                  (d loss / d(dt_s A))
      ddt_s = x_s . u_s + A rho_s,   dA = sum_{b,s} dt_s rho_s
    Each exponent is the sum of the a = dt A it spans, never a difference
    of two cumulative sums, and is <= 0; rho's first term is summed over
    its rectangle (row prefixes, then a column suffix), never as a
    difference of sums.
    -> (dx, ddt, dA, dB, dC), float32."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, A, B, C, gy = _f32(x, dt, A, B, C, gy)
    L = chunk
    nc = max(1, -(-S // L))
    pad = nc * L - S

    def split(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((Bb, nc, L) + t.shape[2:])

    xc, gyc, dtc, Bc, Cc = map(split, (x, gy, dt, B, C))
    a = dtc * A                                            # (Bb,nc,L,H)
    ca = torch.cumsum(a, dim=2)
    la = ca[:, :, -1]                                      # (Bb,nc,H)
    idx = torch.arange(L, device=x.device)
    tri = idx[:, None] >= idx[None, :]                     # (t, s): s <= t
    # ca_t - ca_s as the sum of a over (s, t], and la - ca_s as the sum past
    # s: a difference of two long cumulative sums loses digits under
    # strong decays
    seg = torch.cumsum(a[:, :, :, None] * (idx[:, None] > idx[None, :])
                       [..., None], dim=2)                 # (..,t,s,H)
    E = torch.where(tri[..., None], torch.exp(seg), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    gx = torch.einsum("bcthp,bcshp->bctsh", gyc, xc)
    K = cb[..., None] * E
    Mp = E * dtc[:, :, None] * gx
    M = cb[..., None] * Mp
    past = torch.nn.functional.pad(_suffix_cumsum(a, 2)[:, :, 1:],
                                   (0, 0, 0, 1))           # sum over r > s
    eb = torch.exp(past)                                   # exp(la - ca_s)
    ea = torch.exp(ca)                                     # exp(ca_t)
    G = torch.einsum("bcsh,bcshp,bcsn->bchpn", eb * dtc, xc, Bc)
    D = torch.einsum("bcth,bcthp,bctn->bchpn", ea, gyc, Cc)
    h = (x.new_zeros((Bb, H, P, N)) if initial_state is None
         else initial_state.float())
    hs = []
    for c in range(nc):
        hs.append(h)
        h = torch.exp(la[:, c])[..., None, None] * h + G[:, c]
    g = (x.new_zeros((Bb, H, P, N)) if gstate is None
         else gstate.float())
    gs = [None] * nc
    for c in range(nc - 1, -1, -1):
        gs[c] = g
        g = torch.exp(la[:, c])[..., None, None] * g + D[:, c]
    hc, gc = torch.stack(hs, 1), torch.stack(gs, 1)        # (Bb,nc,H,P,N)
    gB = torch.einsum("bchpn,bcsn->bcshp", gc, Bc)         # Gam_c B_s
    u = torch.einsum("bctsh,bcthp->bcshp", K, gyc) + eb[..., None] * gB
    dx = dtc[..., None] * u
    hty = torch.einsum("bchpn,bcthp->bcthn", hc, gyc)      # h_c^T gy_t
    dC = (torch.einsum("bctsh,bcsn->bctn", Mp, Bc)
          + torch.einsum("bcth,bcthn->bctn", ea, hty))
    gtx = torch.einsum("bchpn,bcshp->bcshn", gc, xc)       # Gam_c^T x_s
    dB = (torch.einsum("bctsh,bctn->bcsn", Mp, Cc)
          + torch.einsum("bcsh,bcshn->bcsn", eb * dtc, gtx))
    # rho: the rectangle t >= s, r < s of M, then the three state terms
    rows = _exclusive_cumsum(M, 3)                         # sum_{r<s} M_tr
    t1 = (rows * tri[..., None]).sum(dim=2)                # over t >= s
    q = ea * torch.einsum("bcthn,bctn->bcth", hty, Cc)
    t2 = _suffix_cumsum(q, 2)
    w = eb * dtc * (xc * gB).sum(-1)
    t3 = _exclusive_cumsum(w, 2)
    t4 = torch.exp(la) * (gc * hc).sum((-1, -2))           # (Bb,nc,H)
    rho = t1 + t2 + t3 + t4[:, :, None]
    ddt = (xc * u).sum(-1) + A * rho
    dA = (dtc * rho).sum((0, 1, 2))

    def join(t):
        return t.reshape((Bb, nc * L) + t.shape[3:])[:, :S]

    return join(dx), join(ddt), dA, join(dB), join(dC)
