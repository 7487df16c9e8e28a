"""xLSTM blocks in PyTorch (arXiv:2405.04517): mLSTM (matrix memory,
chunkwise parallel in prefill) and sLSTM (scalar memory with recurrent gate
weights, scanned token by token in every mode).

The port of the JAX package's `models/xlstm.py`, which has no Pallas kernel:
the cells are plain PyTorch here as they are plain jnp there, and every norm
goes through the RMSNorm wrapper (`layers.rmsnorm`, the CUDA kernel for a
CUDA tensor).

mLSTM recurrence per head, with the stabilized exponential gates:
    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = f~_t C_{t-1} + i~_t k_t v_t^T    n_t = f~_t n_{t-1} + i~_t k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))
C and n are kept scaled by exp(-m), so h does not depend on where the
stabilizer sits, and the state after a sequence does not depend on how the
sequence is cut into chunks.

Params arrive in their working dtype (see `repro_torch.convert`): the
projections in cfg.dtype; the gate biases b_i, b_f and b_gates, the sLSTM's
recurrent weights r_gates and the norm scales in float32, which the JAX
package computes with. The states are float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    inner = 2 * cfg.d_model
    H = cfg.n_heads
    return inner, H, inner // H


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, dtype,
               device=None) -> dict:
    """The JAX package's shapes and init law, drawn from `gen`."""
    d = cfg.d_model
    inner, H, _ = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def w(shape):
        return dense_init(gen, shape, dtype=dtype, device=device)
    return {
        "w_up": w((d, 2 * inner)),                 # x_m | z
        "wq": w((inner, inner)),
        "wk": w((inner, inner)),
        "wv": w((inner, inner)),
        "w_if": w((inner, 2 * H)),                 # i, f gate logits
        "b_i": torch.zeros(H, **f32),
        "b_f": torch.full((H,), 3.0, **f32),       # forget-bias init
        "norm_scale": torch.ones(inner, **f32),
        "w_down": w((inner, d)),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The state a prefill starts from: C and n zero, m at -1e30."""
    _, H, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def _mlstm_in(cfg: ModelConfig, params: dict, u: torch.Tensor):
    """u (B, S, D) -> z (B, S, inner) in u's dtype; q (scaled), k, v (B, H,
    S, hd) and the gates log_i, log_f (B, H, S), all float32."""
    B, S, _ = u.shape
    inner, H, hd = mlstm_dims(cfg)
    up = u @ params["w_up"]
    xm, z = up[..., :inner], up[..., inner:]

    def heads(w):
        return (xm @ w).view(B, S, H, hd).transpose(1, 2).float()
    q = heads(params["wq"]) / math.sqrt(hd)
    k, v = heads(params["wk"]), heads(params["wv"])
    g = (xm @ params["w_if"]).float().transpose(1, 2)        # (B, 2H, S)
    log_i = g[:, :H] + params["b_i"][:, None]
    log_f = F.logsigmoid(g[:, H:] + params["b_f"][:, None])
    return z, q, k, v, log_i, log_f


def _mlstm_out(cfg: ModelConfig, params: dict, h: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """h (B, H, S, hd) float32 -> the block's output (B, S, D)."""
    B, _, S, _ = h.shape
    h = h.transpose(1, 2).reshape(B, S, -1).to(z.dtype)
    h = rmsnorm(h, params["norm_scale"], cfg.norm_eps)
    return (h * F.silu(z)) @ params["w_down"]


def _mlstm_chunk(q, k, v, log_i, log_f, C, n, m, causal):
    """One chunk of L positions from the state (C (B,H,hd,hd), n (B,H,hd),
    m (B,H)): the JAX package's `chunk_step`. q, k, v: (B,H,L,hd); log_i,
    log_f: (B,H,L); causal: (L, L) bool, lower triangle. Returns h
    (B,H,L,hd) and the state after the chunk."""
    csum = torch.cumsum(log_f, dim=-1)                 # decay from the start
    tot = csum[..., -1]
    log_a = csum + m[..., None]                        # state path
    # pair decays D[t, s] = sum_{s<r<=t} log f_r + log i_s for s <= t
    D = csum[..., :, None] - csum[..., None, :] + log_i[..., None, :]
    D = D.masked_fill(~causal, float("-inf"))
    m_new = torch.maximum(log_a, D.amax(dim=-1))       # running stabilizer
    sa = torch.exp(log_a - m_new)
    h_num = (q @ C) * sa[..., None]
    n_tot = (q @ n[..., None])[..., 0] * sa
    scores = (q @ k.transpose(-1, -2)) * torch.exp(D - m_new[..., None])
    h_num = h_num + scores @ v
    n_tot = n_tot + scores.sum(dim=-1)
    denom = torch.maximum(n_tot.abs(), torch.exp(-m_new))
    h = h_num / denom[..., None]
    # the state at the end of the chunk
    to_end = log_i + (tot[..., None] - csum)
    m_end = torch.maximum(tot + m, to_end.amax(dim=-1))
    decay = torch.exp(tot + m - m_end)
    kw = k * torch.exp(to_end - m_end[..., None])[..., None]
    C = C * decay[..., None, None] + kw.transpose(-1, -2) @ v
    n = n * decay[..., None] + kw.sum(dim=-2)
    return h, C, n, m_end


def mlstm_fwd(cfg: ModelConfig, params: dict, u: torch.Tensor,
              state: Optional[dict] = None, return_state: bool = False):
    """Full-sequence chunkwise-parallel mLSTM over u (B, S, D), from
    `state` ({C, n, m}; default `init_mlstm_state`). Returns out, or (out,
    the final state) with `return_state`.

    Chunks of cfg.ssm_chunk positions, the last one shorter. The JAX
    package halves its chunk until it divides S (a 37-token prompt runs
    37 chunks of 1, one scan step each); the chunkwise form is exact for
    any cut of the sequence, so the two agree up to float rounding, and
    eager PyTorch makes ceil(S / ssm_chunk) chunk steps."""
    B, S, _ = u.shape
    z, q, k, v, log_i, log_f = _mlstm_in(cfg, params, u)
    st = state or init_mlstm_state(cfg, B, u.device)
    C, n, m = st["C"], st["n"], st["m"]
    Q = min(cfg.ssm_chunk or 256, S)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    hs = []
    for s0 in range(0, S, Q):
        L = min(Q, S - s0)
        sl = slice(s0, s0 + L)
        h, C, n, m = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  log_i[..., sl], log_f[..., sl], C, n, m,
                                  causal[:L, :L])
        hs.append(h)
    out = _mlstm_out(cfg, params, torch.cat(hs, dim=2), z)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def mlstm_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
                 state: dict, active: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The O(1) recurrent step on u (B, 1, D). The state {C (B,H,hd,hd), n
    (B,H,hd), m (B,H)} is updated in place. `active` (B,) bool leaves
    inactive rows' states as they were (the JAX package advances every
    row): their decay is 1, their input 0 and their m kept, so no select
    pass over C is needed. Their outputs are unspecified."""
    z, q, k, v, log_i, log_f = _mlstm_in(cfg, params, u)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]               # (B, H, hd)
    log_i, log_f = log_i[..., 0], log_f[..., 0]                # (B, H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    fs = torch.exp(log_f + m - m_new)
    is_ = torch.exp(log_i - m_new)
    if active is not None:
        a = active[:, None]
        m_new = torch.where(a, m_new, m)
        fs = torch.where(a, fs, 1.0)
        is_ = torch.where(a, is_, 0.0)
    ik = is_[..., None] * k
    C.mul_(fs[..., None, None]).addcmul_(ik[..., :, None], v[..., None, :])
    n.mul_(fs[..., None]).add_(ik)
    m.copy_(m_new)
    h_num = (q[..., None, :] @ C)[..., 0, :]
    denom = torch.maximum((q * n).sum(dim=-1).abs(), torch.exp(-m_new))
    return _mlstm_out(cfg, params, (h_num / denom[..., None])[:, :, None],
                      z)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM_STATE = ("h", "c", "n", "m")


def init_slstm(cfg: ModelConfig, gen: torch.Generator, dtype,
               device=None) -> dict:
    """The JAX package's shapes and init law, drawn from `gen`; r_gates
    and b_gates (i, f, z, o by quarters; f's bias 3) in float32."""
    d = cfg.d_model
    ff = max(1, (4 * d) // 3)
    f32 = dict(dtype=torch.float32, device=device)
    b = torch.zeros(4 * d, **f32)
    b[d:2 * d] = 3.0
    return {
        "w_gates": dense_init(gen, (d, 4 * d), dtype=dtype, device=device),
        "r_gates": dense_init(gen, (d, 4 * d), device=device),
        "b_gates": b,
        "norm_scale": torch.ones(d, **f32),
        "w_ff_gate": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "w_ff_up": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "w_ff_down": dense_init(gen, (ff, d), dtype=dtype, device=device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The state a prefill starts from: h and c zero, n at 1e-6, m at
    -1e30."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z + 1e-6, "m": z - 1e30}


def _slstm_step(r_gates: torch.Tensor, xb: torch.Tensor, h, c, n, m):
    """One token: xb (B, 4d) is the input projection plus b_gates, float32.
    Returns the new (h, c, n, m)."""
    g = torch.addmm(xb, h, r_gates)
    gi, gf, gz, go = g.chunk(4, dim=-1)
    lfm = F.logsigmoid(gf) + m
    m_new = torch.maximum(lfm, gi)
    i_ = torch.exp(gi - m_new)
    f_ = torch.exp(lfm - m_new)
    c = torch.addcmul(f_ * c, i_, torch.tanh(gz))
    n = torch.addcmul(i_, f_, n)
    h = torch.sigmoid(go) * c / n.clamp_min(1e-6)
    return h, c, n, m_new


def _slstm_in(params: dict, u: torch.Tensor) -> torch.Tensor:
    return (u @ params["w_gates"]).float() + params["b_gates"]


def _slstm_out(cfg: ModelConfig, params: dict, h: torch.Tensor,
               dtype) -> torch.Tensor:
    """The norm and the gated FFN (projection factor 4/3, tanh GELU as
    jax.nn.gelu's default) over h (B, S, d)."""
    h = rmsnorm(h.to(dtype), params["norm_scale"], cfg.norm_eps)
    gate = F.gelu(h @ params["w_ff_gate"], approximate="tanh")
    return (gate * (h @ params["w_ff_up"])) @ params["w_ff_down"]


def slstm_fwd(cfg: ModelConfig, params: dict, u: torch.Tensor,
              state: Optional[dict] = None, return_state: bool = False):
    """u (B, S, D), scanned token by token from `state` ({h, c, n, m};
    default `init_slstm_state`). Returns out, or (out, the final state)
    with `return_state`."""
    B, S, _ = u.shape
    xb = _slstm_in(params, u).transpose(0, 1).contiguous()      # (S, B, 4d)
    st = state or init_slstm_state(cfg, B, u.device)
    h, c, n, m = (st[k] for k in SLSTM_STATE)
    r = params["r_gates"]
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_step(r, xb[t], h, c, n, m)
        hs.append(h)
    out = _slstm_out(cfg, params, torch.stack(hs, dim=1), u.dtype)
    if return_state:
        return out, dict(zip(SLSTM_STATE, (h, c, n, m)))
    return out


def slstm_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
                 state: dict, active: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One token u (B, 1, D). The state {h, c, n, m} (B, d) is updated in
    place; `active` (B,) bool keeps inactive rows' states as they were
    (a select: the state is one row of d_model a slot). Their outputs are
    unspecified."""
    new = _slstm_step(params["r_gates"], _slstm_in(params, u[:, 0]),
                      *(state[k] for k in SLSTM_STATE))
    for key, val in zip(SLSTM_STATE, new):
        old = state[key]
        old.copy_(val if active is None
                  else torch.where(active[:, None], val, old))
    return _slstm_out(cfg, params, new[0][:, None], u.dtype)
