"""Plain float32 reference of the Mamba2 + shared-attention hybrid
(zamba2-2.7b as served): `n_layers` pre-norm Mamba2 blocks, and after
every `shared_attn_every`-th of them one application of a single
weight-tied attention + SwiGLU block (its weights drawn at its first
application), then the final RMSNorm and the unembedding.

A Mamba2 block (arXiv:2405.21060, one group): in_proj -> [z | x | B | C |
dt], a depthwise causal conv of width `ssm_conv` on x then SiLU,
dt = softplus(dt + dt_bias), A = -exp(A_log) one scalar a head,
  h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t,
then RMSNorm(y * SiLU(z)) and out_proj. The scan is computed exactly in
chunks of 64 rows (the quadratic form within a chunk, the state across).
dt_bias, the conv bias start at zero, D and the norm scales at one, and
A_log at log(1..H); none takes a draw.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pice_bench.reference import common


def dims(spec: dict):
    inner = spec["ssm_expand"] * spec["d_model"]
    H = spec["ssm_heads"] or max(1, inner // 64)
    return inner, H, inner // H, spec["ssm_state"]


def draw_mamba(spec: dict, d: common.Draws) -> dict:
    inner, H, _, N = dims(spec)
    conv_w = d.scaled((spec["ssm_conv"], inner), 0.1)
    w_in = d.dense((spec["d_model"], 2 * inner + 2 * N + H))
    w_out = d.dense((inner, spec["d_model"]))
    return {"conv_w": conv_w, "w_in": w_in, "w_out": w_out}


def ssd(x, dt, A, B, C, chunk: int = 64):
    """x (S, H, P), dt (S, H), A (H,), B / C (S, N) -> y (S, H, P)."""
    S, H, P = x.shape
    N = B.shape[1]
    h = x.new_zeros((H, P, N))
    ys = []
    for s in range(0, S, chunk):
        e = min(s + chunk, S)
        xc, dc, Bc, Cc = x[s:e], dt[s:e], B[s:e], C[s:e]
        cum = torch.cumsum(dc * A, dim=0)                     # (Q, H)
        Q = e - s
        seg = cum[:, None, :] - cum[None, :, :]                # (Q, Q, H)
        low = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        L = torch.exp(torch.where(low[:, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
        CB = Cc @ Bc.T                                         # (Q, Q)
        w = CB[:, :, None] * L * dc[None, :, :]                # (Q, Q, H)
        y = torch.einsum("ijh,jhp->ihp", w, xc)
        y = y + torch.exp(cum)[:, :, None] * torch.einsum("in,hpn->ihp",
                                                          Cc, h)
        decay_to_end = torch.exp(cum[-1][None, :] - cum)       # (Q, H)
        h = torch.exp(cum[-1])[:, None, None] * h + torch.einsum(
            "jh,jhp,jn->hpn", decay_to_end * dc, xc, Bc)
        ys.append(y)
    return torch.cat(ys, dim=0)


def mamba_block(spec: dict, p: dict, x: torch.Tensor, fp8: bool
                ) -> torch.Tensor:
    inner, H, P, N = dims(spec)
    eps = spec["norm_eps"]
    S = x.shape[0]
    pr = common.proj(common.rmsnorm(x, eps), p["w_in"], fp8)
    z, xs = pr[:, :inner], pr[:, inner:2 * inner]
    Bm = pr[:, 2 * inner:2 * inner + N]
    Cm = pr[:, 2 * inner + N:2 * inner + 2 * N]
    dt = pr[:, 2 * inner + 2 * N:]
    K = spec["ssm_conv"]
    w = p["conv_w"].float()
    xp = torch.cat([xs.new_zeros((K - 1, inner)), xs], dim=0)
    conv = sum(xp[i:i + S] * w[i] for i in range(K))
    xs = F.silu(conv)
    dt = F.softplus(dt)
    A = -torch.exp(torch.log(torch.linspace(1.0, float(H), H,
                                            dtype=torch.float32,
                                            device=x.device)))
    xh = xs.view(S, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + xh
    y = common.rmsnorm(y.reshape(S, inner) * F.silu(z), eps)
    return x + common.proj(y, p["w_out"], fp8)


def layer_fns(spec: dict):
    shared = {}

    def draw_shared(d):
        if not shared:
            shared.update(common.draw_attention_layer(spec, d))
        return shared

    every = spec["shared_attn_every"]
    for i in range(spec["n_layers"]):
        yield (lambda d: draw_mamba(spec, d),
               lambda p, x, fp8: mamba_block(spec, p, x, fp8))
        if (i + 1) % every == 0:
            yield (draw_shared,
                   lambda p, x, fp8: common.attention_block(spec, p, x, fp8))


def run(spec: dict, seed: int, seqs, device, control: bool = False):
    """See `common.run_sequences`."""
    return common.run_sequences(spec, seed, seqs, device, layer_fns, control)
