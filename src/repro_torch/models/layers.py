"""Common neural-net layers (PyTorch): norms, RoPE, SwiGLU MLP, embeddings.

Parameters arrive already in their working dtype (see `init_params` and
`repro_torch.convert`): matmul weights, embeddings and biases in the compute
dtype `cfg.dtype`, norm scales in float32. The JAX package keeps float32
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
# scales, Mamba2's A_log, D and dt_bias (the JAX package casts them to
# float32 at use), the xLSTM gate biases and the sLSTM's recurrent weights
# (which it computes with in float32), and the length head.
FLOAT32_LEAVES = ("scale", "q_norm", "k_norm", "A_log", "D", "dt_bias",
                  "norm_scale", "b_i", "b_f", "b_gates", "r_gates",
                  "length_head")


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


def norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        raise NotImplementedError(
            "LayerNorm families (whisper) wait for the encoder-decoder slice")
    return rmsnorm(x, params["scale"], cfg.norm_eps)


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
# MLP (SwiGLU; the gated-GELU-free families of the dense slice)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype, device=device),
    }


def mlp(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" not in params:
        raise NotImplementedError(
            "the ungated GELU MLP waits for the encoder-decoder slice")
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


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
