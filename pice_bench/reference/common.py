"""Plain float32 reference shared by the architectures: the weight law, the
layers, and the comparison of served tokens.

Imports torch and numpy only. The weights are worked out again from the
seed: the law (N(0, 1/fan_in) matrices, N(0, 0.02^2) embeddings, Mamba2's
conv N(0, 0.1^2), every draw in float32 from one `torch.Generator` on the
device, one tensor at a time, in the order of the layers, then rounded to
the served dtype) is the one the served weights were drawn by, so the same
seed gives the same values. The reference then computes in float32 with
TF32 off.

The control (`fp8=True`) is the same computation with every projection's
two operands rounded to float8 e4m3, the activations with one scale a
row and the weights with one scale an output column: the precision below
the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
FP8_MAX = 448.0


def highest_precision() -> None:
    """Float32 matmuls in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Draws:
    """The served weights' draws, in order, from one generator."""

    def __init__(self, seed: int, device, dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device
        self.dtype = dtype

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, dtype=torch.float32,
                           device=self.device)

    def dense(self, shape, in_axis: int = 0) -> torch.Tensor:
        w = self._randn(shape)
        return (w * (1.0 / float(shape[in_axis]) ** 0.5)).to(self.dtype)

    def embed(self, shape) -> torch.Tensor:
        return (self._randn(shape) * 0.02).to(self.dtype)

    def scaled(self, shape, scale: float) -> torch.Tensor:
        return (self._randn(shape) * scale).to(self.dtype)


def head_dim(spec: dict) -> int:
    return spec["head_dim"] or spec["d_model"] // spec["n_heads"]


def draw_embedding(spec: dict, d: Draws) -> Dict[str, torch.Tensor]:
    """{"tok": (V, D), "unembed": (D, V) or tok.T when tied}."""
    tok = d.embed((spec["vocab_size"], spec["d_model"]))
    if spec["tie_embeddings"]:
        return {"tok": tok, "unembed": tok.T}
    return {"tok": tok, "unembed": d.dense((spec["d_model"],
                                            spec["vocab_size"]))}


def draw_attention_layer(spec: dict, d: Draws) -> Dict[str, torch.Tensor]:
    """An attention + SwiGLU block: wq (D, Hq*hd), wk / wv (D, Hkv*hd), wo
    (Hq*hd, D) with fan-in hd, w_gate / w_up (D, F), w_down (F, D); the
    biases start at zero and the norm scales at one, so they take no draw
    and the reference leaves them out."""
    D, hd = spec["d_model"], head_dim(spec)
    nq, nkv, ff = spec["n_heads"], spec["n_kv_heads"], spec["d_ff"]
    p = {"wq": d.dense((D, nq, hd)).reshape(D, nq * hd),
         "wk": d.dense((D, nkv, hd)).reshape(D, nkv * hd),
         "wv": d.dense((D, nkv, hd)).reshape(D, nkv * hd),
         "wo": d.dense((nq, hd, D), in_axis=1).reshape(nq * hd, D)}
    p["w_gate"] = d.dense((D, ff))
    p["w_up"] = d.dense((D, ff))
    p["w_down"] = d.dense((ff, D))
    return p


# ---------------------------------------------------------------------------
# Layers, in float32
# ---------------------------------------------------------------------------

def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (last axis)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_cols(w: torch.Tensor) -> torch.Tensor:
    """w (in, out) rounded to float8 e4m3 with one scale an output column."""
    s = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def proj(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (S, in) @ w (in, out) in float32; the control rounds both operands
    to float8 first."""
    w = w.float()
    if fp8:
        return fp8_rows(x) @ fp8_cols(w)
    return x @ w


def rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its scale of ones."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1, rotate-half."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """q (S, Hq, hd), k / v (S, Hkv, hd) -> (S, Hq, hd); query head h reads
    kv head h // (Hq / Hkv). Scores in blocks of query rows."""
    S, Hq, hd = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (Hq, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1)
    out = torch.empty_like(qt)
    scale = 1.0 / math.sqrt(hd)
    keys = torch.arange(S, device=q.device)
    for s in range(0, S, block):
        e = min(s + block, S)
        sc = (qt[:, s:e] @ k[:, :e].transpose(1, 2)) * scale
        mask = keys[None, :e] > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, s:e] = torch.softmax(sc, dim=-1) @ v[:, :e]
    return out.transpose(0, 1)


def attention_block(spec: dict, p: dict, x: torch.Tensor, fp8: bool
                    ) -> torch.Tensor:
    """x + attention(norm1 x), then + SwiGLU(norm2 x): one sequence (S, D)."""
    eps, hd = spec["norm_eps"], head_dim(spec)
    S = x.shape[0]
    h = rmsnorm(x, eps)
    q = proj(h, p["wq"], fp8).view(S, spec["n_heads"], hd)
    k = proj(h, p["wk"], fp8).view(S, spec["n_kv_heads"], hd)
    v = proj(h, p["wv"], fp8).view(S, spec["n_kv_heads"], hd)
    if spec["qk_norm"]:
        q, k = rmsnorm(q, eps), rmsnorm(k, eps)
    q, k = rope(q, spec["rope_theta"]), rope(k, spec["rope_theta"])
    o = causal_attention(q, k, v).reshape(S, -1)
    x = x + proj(o, p["wo"], fp8)
    h = rmsnorm(x, eps)
    a = F.silu(proj(h, p["w_gate"], fp8)) * proj(h, p["w_up"], fp8)
    return x + proj(a, p["w_down"], fp8)


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def judge(logits: torch.Tensor, served: Sequence[int],
          served_lps: Sequence[float]) -> Dict[str, float]:
    """logits (T, V): the reference's float32 logits at the positions that
    produced the T served tokens. `gap`: the widest margin by which a served
    token's logit lies below the reference's best; `lp`: the widest
    difference between a served token's logprob and the reference's;
    `lp_sum`: the sum of those differences over the T tokens (`n`)."""
    tok = torch.tensor(list(served), dtype=torch.long, device=logits.device)
    best = logits.max(dim=-1).values
    got = logits.gather(1, tok[:, None])[:, 0]
    lp_ref = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    lp = torch.tensor(list(served_lps), dtype=torch.float32,
                      device=logits.device)
    diff = (lp - lp_ref).abs()
    return {"gap": float((best - got).max()), "lp": float(diff.max()),
            "lp_sum": float(diff.sum()), "n": len(served)}


def judge_control(ref: torch.Tensor, low: torch.Tensor) -> Dict[str, float]:
    """The control at each position: the token the lower precision puts
    first, judged as `judge` judges a served token (its own logprob against
    the reference's)."""
    tok = low.argmax(dim=-1)
    best = ref.max(dim=-1).values
    got = ref.gather(1, tok[:, None])[:, 0]
    lp_ref = torch.log_softmax(ref, dim=-1).gather(1, tok[:, None])[:, 0]
    lp_low = torch.log_softmax(low, dim=-1).gather(1, tok[:, None])[:, 0]
    diff = (lp_low - lp_ref).abs()
    return {"gap": float((best - got).max()), "lp": float(diff.max()),
            "lp_sum": float(diff.sum())}


def logits_at(spec: dict, emb: dict, x: torch.Tensor, rows: List[int],
              fp8: bool) -> torch.Tensor:
    """Final norm and unembedding of hidden rows `rows` of x (S, D)."""
    h = rmsnorm(x[rows], spec["norm_eps"])
    return proj(h, emb["unembed"], fp8)


def run_sequences(spec: dict, seed: int, seqs: List[dict], device,
                  layer_fns, control: bool) -> List[Dict[str, float]]:
    """Drive every sequence through the stack layer by layer (weights drawn
    once, in order, and dropped after their layer).

    seqs: [{"tokens": prompt + served[:-1], "rows": positions that produced
    the served tokens, "served": [...], "lps": [...]}]. `layer_fns` yields
    (draw, apply) pairs in the stack's order: `draw(d)` returns the layer's
    weights, `apply(p, x, fp8)` the layer's output for one sequence.
    Returns, for each sequence, {"gap", "lp", "lp_sum", "n"} and with
    `control` {"control_gap", "control_lp", "control_lp_sum"}."""
    highest_precision()
    d = Draws(seed, device, DTYPES[spec["dtype"]])
    emb = draw_embedding(spec, d)
    modes = [False, True] if control else [False]
    xs = {m: [emb["tok"][torch.tensor(s["tokens"], device=device)].float()
              for s in seqs] for m in modes}
    for draw, apply in layer_fns(spec):
        p = draw(d)
        for m in modes:
            xs[m] = [apply(p, x, m) for x in xs[m]]
        del p
    out = []
    for i, s in enumerate(seqs):
        ref = logits_at(spec, emb, xs[False][i], s["rows"], False)
        r = judge(ref, s["served"], s["lps"])
        if control:
            low = logits_at(spec, emb, xs[True][i], s["rows"], True)
            c = judge_control(ref, low)
            r.update(control_gap=c["gap"], control_lp=c["lp"],
                     control_lp_sum=c["lp_sum"])
        out.append(r)
    return out
