"""Mamba2 (SSD) block in PyTorch: the chunked scan for prefill and scoring,
the O(1) recurrent update for decode.

The port of the JAX package's `models/ssm.py`. Structure follows
arXiv:2405.21060 (Mamba2) as used by Zamba2 (arXiv:2411.15242):
  in_proj -> [z | x | B | C | dt], short causal conv on x, SSD recurrence
  h_t = exp(A*dt_t) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t^T h_t + D x_t
with scalar A per head (SSD restriction), multi-head x (H heads of P dims),
shared B/C across heads (n_groups=1), gated output y * silu(z).

Params arrive in their working dtype (see `repro_torch.convert`): w_in,
w_out, conv_w and conv_b in cfg.dtype; A_log, D, dt_bias and norm_scale in
float32, which the JAX package casts to at use. The scan runs in float32
through `kernels.ssm_scan` (the CUDA kernel for a CUDA tensor). The decode
step is plain PyTorch, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.resolved_ssm_heads
    head_dim = inner // n_heads
    return inner, n_heads, head_dim, cfg.ssm_state


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype,
                device=None) -> dict:
    """The JAX package's shapes and init law, drawn from `gen`."""
    d = cfg.d_model
    inner, H, P, N = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv, inner), generator=gen, **f32) * 0.1
    return {
        "w_in": dense_init(gen, (d, 2 * inner + 2 * N + H), dtype=dtype,
                           device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(inner, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, float(H), H, **f32)),
        "D": torch.ones(H, **f32),
        "dt_bias": torch.zeros(H, **f32),
        "norm_scale": torch.ones(inner, **f32),
        "w_out": dense_init(gen, (inner, d), dtype=dtype, device=device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    inner, H, P, N = ssm_dims(cfg)
    z, xbc = proj[..., :inner], proj[..., inner:]
    x = xbc[..., :inner]
    B = xbc[..., inner:inner + N]
    C = xbc[..., inner + N:inner + 2 * N]
    dt = xbc[..., inner + 2 * N:]
    return z, x, B, C, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,inner), w: (K,inner), state
    (B,K-1,inner) or None (zeros). Returns (y, new_state): the state is the
    last K-1 rows of [state | x]."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+K-1, inner)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return y + b.to(x.dtype), new_state


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan (`kernels.ssm_scan`).

    x: (Bb,S,H,P), dt: (Bb,S,H) (already softplus'ed), A: (H,) negative,
    B/C: (Bb,S,N), all float32. Returns (y (Bb,S,H,P), final_state
    (Bb,H,P,N))."""
    return ssd_ops.ssm_scan(x, dt, A, B, C, chunk=chunk,
                            initial_state=initial_state)


def _gated_out(cfg: ModelConfig, params: dict, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"]


def mamba2_fwd(cfg: ModelConfig, params: dict, u: torch.Tensor,
               conv_state: Optional[torch.Tensor] = None,
               ssd_state: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """u: (Bb, S, D). Full-sequence path (prefill, scoring). Returns out, or
    (out, conv_state (Bb,K-1,inner), ssd_state (Bb,H,P,N) float32) with
    `return_state`."""
    dt_ = u.dtype
    Bb, S, _ = u.shape
    inner, H, P, N = ssm_dims(cfg)
    proj = u @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(cfg, proj)
    x, new_conv = _causal_conv(x, params["conv_w"], params["conv_b"],
                               conv_state)
    x = F.silu(x)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = x.reshape(Bb, S, H, P)
    y, final_state = ssd_chunked(
        xh.float().contiguous(), dt.contiguous(), A,
        Bm.float().contiguous(), Cm.float().contiguous(), cfg.ssm_chunk,
        initial_state=ssd_state)
    y = y + xh.float() * params["D"].float()[None, None, :, None]
    out = _gated_out(cfg, params, y.reshape(Bb, S, inner).to(dt_), z)
    if return_state:
        return out, new_conv, final_state
    return out


def mamba2_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
                  conv_state: torch.Tensor, ssd_state: torch.Tensor,
                  active: Optional[torch.Tensor] = None):
    """Single-token recurrent step. u: (Bb, 1, D); conv_state: (Bb, K-1,
    inner) in cfg.dtype; ssd_state: (Bb, H, P, N) float32.

    Both states are updated in place and returned with the output:
    (out, conv_state, ssd_state). `active` (Bb,) bool leaves the states of
    inactive rows as they were (the JAX package advances every row): their
    decay is 1 and their update 0, so the state row is kept exactly, and
    their conv rows are kept by a select. Their outputs are unspecified."""
    dt_ = u.dtype
    Bb = u.shape[0]
    inner, H, P, N = ssm_dims(cfg)
    proj = u @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(cfg, proj)
    x, new_conv = _causal_conv(x, params["conv_w"], params["conv_b"],
                               conv_state)
    x = F.silu(x)[:, 0]                                        # (Bb, inner)
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # (Bb,H)
    A = -torch.exp(params["A_log"].float())                    # (H,)
    xh = x.reshape(Bb, H, P).float()
    Bv = Bm[:, 0].float()                                      # (Bb,N)
    Cv = Cm[:, 0].float()
    if active is not None:
        dt = dt * active[:, None]           # bool promotes inside the mul
        new_conv = torch.where(active[:, None, None], new_conv, conv_state)
    decay = torch.exp(dt * A[None, :])                         # (Bb,H)
    upd = (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    ssd_state.mul_(decay[:, :, None, None]).add_(upd)
    conv_state.copy_(new_conv)
    y = torch.einsum("bhpn,bn->bhp", ssd_state, Cv)
    y = y + xh * params["D"].float()[None, :, None]
    out = _gated_out(cfg, params, y.reshape(Bb, 1, inner).to(dt_), z)
    return out, conv_state, ssd_state
