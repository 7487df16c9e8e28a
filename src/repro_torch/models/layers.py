"""Common neural-net layers (PyTorch): norms (RMSNorm, and LayerNorm for
whisper), RoPE, the SwiGLU and the ungated GELU MLP, embeddings.

Parameters arrive already in their working dtype (see `init_params` and
`repro_torch.convert`): matmul weights, embeddings and biases in the compute
dtype `cfg.dtype`, norm scales and biases in float32. The JAX package keeps float32
parameters and casts each one at every use; casting once when the weights
are loaded gives the same values without re-reading float32 weights on every
step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.config import ModelConfig

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


# Leaves kept in float32 in the working params, whatever cfg.dtype: norm
# scales and LayerNorm biases, Mamba2's A_log, D and dt_bias (the JAX
# package casts them to float32 at use), the xLSTM gate biases and the
# sLSTM's recurrent weights (which it computes with in float32), the length
# head and the reward model's head.
FLOAT32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "A_log", "D",
                  "dt_bias", "norm_scale", "b_i", "b_f", "b_gates", "r_gates",
                  "length_head", "reward_head")


def working_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype the leaf called `name` (its key in the params) is used in:
    float32 for FLOAT32_LEAVES, cfg.dtype for the rest (matmul weights,
    embeddings, biases, Mamba2's conv)."""
    return torch.float32 if name in FLOAT32_LEAVES else compute_dtype(cfg)


# ---------------------------------------------------------------------------
# Initializers (the JAX package's law: N(0, 1/fan_in) dense, N(0, 0.02^2)
# embeddings), drawn one tensor at a time in float32 from `gen` and stored
# in `dtype`, so the peak host/device memory is one float32 tensor.
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / float(shape[in_axis]) ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Every norm of the served stacks (norm1, norm2, the final norm,
    q_norm / k_norm, Mamba2's gated norm) goes through the RMSNorm
    wrapper: one kernel launch on a CUDA tensor; on a CPU tensor its plain
    version, the JAX package's jnp arithmetic step for step (the mean of
    squares in float32, the output in x's dtype)."""
    return rms_ops.rmsnorm(x, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's LayerNorm step for step in float32: the mean, the
    mean of squared deviations, rsqrt(var + eps), scale and bias; the
    output in x's dtype. Plain PyTorch on every device: the JAX package
    computes it in plain jnp, with no kernel."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, d: int, device=None) -> dict:
    """{"scale": ones} in float32, and {"bias": zeros} for LayerNorm."""
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.use_layernorm:
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (..., S, 1, hd/2) for positions (..., S). A model
    call computes them once and every layer reuses them."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs
    angles = angles[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               theta: float = 1e6,
               tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S), or
    precomputed `tables` from `rope_tables`."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: SwiGLU, or the ungated GELU MLP with biases (whisper)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None, gated: bool = True) -> dict:
    if not gated:
        return {
            "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype,
                               device=device),
            "b_up": torch.zeros(d_ff, dtype=dtype, device=device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype,
                                 device=device),
            "b_down": torch.zeros(d_model, dtype=dtype, device=device),
        }
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype, device=device),
    }


def mlp(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:  # SwiGLU
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        return (F.silu(g) * u) @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation; F.gelu's default erf
    # form differs from it by up to 4.7e-4
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device=None) -> dict:
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  dtype=dtype, device=device)
    return p


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w
