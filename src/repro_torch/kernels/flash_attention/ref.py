"""Plain PyTorch version of full-sequence GQA attention (causal or not,
sliding window, tanh softcap): the numerics contract for the CUDA kernel,
written as the JAX package's oracle (`repro/kernels/flash_attention/ref.py`
`mha_ref`) is; and its backward written out, the contract for the backward
kernel, with a model of the bf16 backward kernel's rounding points beside
it."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention.ref import (NEG_INF,
                                                           softmax_scale)


def _mask(S, causal, window, device):
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = ki <= qi
    if window:
        mask = mask & (ki > qi - window)
    return mask


def _repeat(t, rep):
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def _scores(q, k, causal, window, softcap):
    """The kept scores (B, Hq, S, S) in float32 (softcapped), the mask."""
    B, S, Hq, hd = q.shape
    k = _repeat(k, Hq // k.shape[2])
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits, _mask(S, causal, window, q.device)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    logits, mask = _scores(q, k, causal, window, softcap)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    v = _repeat(v, q.shape[2] // v.shape[2])
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)


def flash_attention_lse_ref(q, k, v, causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """`flash_attention_ref` and the log-sum-exp of each query row's kept
    scores, (B, Hq, S) float32: what the kernel hands its backward."""
    logits, mask = _scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(torch.where(mask, logits, NEG_INF), dim=-1)
    return flash_attention_ref(q, k, v, causal, window, softcap), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """The backward of `flash_attention_ref`, written out in float32 from
    the forward's output o and log-sum-exp lse (B, Hq, S):
      P  = exp(s - lse) on the kept scores s, 0 elsewhere
      D  = rowsum(dO * O)
      dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
      with a softcap c, s = c tanh(u / c) of the scaled score u, and
      dU = dS * (1 - (s / c)^2); else dU = dS
      dQ = scale dU K,  dK = scale dU^T Q
    dK and dV summed over each kv head's q_per_kv query heads. -> (dq, dk,
    dv) in the inputs' dtype."""
    return _bwd(q, k, v, o, lse, do, causal, window, softcap, lambda t: t)


def flash_attention_bwd_mma_ref(q, k, v, o, lse, do, causal: bool = True,
                                window: int = 0, softcap: float = 0.0):
    """`flash_attention_bwd_ref` with the bfloat16 kernel's rounding points:
    the products run on bf16 operands with float32 sums, so P is rounded to
    bf16 before dV = P^T dO, and scale dU before dQ = (scale dU) K and dK =
    (scale dU)^T Q; S, dP, D and the GQA sums stay float32 (q, k, v, o and
    dO are bf16 already on the card). The plain model of the tensor-core
    kernel, held against the JAX package's gradients on the CPU."""
    return _bwd(q, k, v, o, lse, do, causal, window, softcap,
                lambda t: t.to(torch.bfloat16).float())


def _bwd(q, k, v, o, lse, do, causal, window, softcap, rnd):
    """The backward, with `rnd` applied to P and scale dU before the
    products they feed."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = softmax_scale(hd)
    s, mask = _scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    D = (dof * o.float()).sum(dim=-1).transpose(1, 2)          # (B, Hq, S)
    dv = torch.einsum("bnqk,bqnh->bknh", rnd(p), dof)
    dp = torch.einsum("bqnh,bknh->bnqk", dof, _repeat(v, rep).float())
    ds = p * (dp - D[..., None])
    if softcap:
        ds = ds * (1.0 - (s / softcap).square())
    ds = rnd(ds * scale)
    dq = torch.einsum("bnqk,bknh->bqnh", ds, _repeat(k, rep).float())
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q.float())
    dk = dk.reshape(B, S, Hkv, rep, hd).sum(dim=3)
    dv = dv.reshape(B, S, Hkv, rep, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
