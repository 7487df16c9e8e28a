"""Registry of the configurations the PyTorch port serves.

Each config module `repro_torch.configs.<id>` exposes CONFIG, the full-size
configuration with its source. All ten architectures of the JAX package are
listed: the dense GQA decoders (the PICE cloud/edge pairing, granite-3-8b,
minitron-8b), the MoE decoders (qwen3-moe-30b-a3b, and mixtral-8x7b with
its sliding window), the xLSTM stack and the Mamba2 + shared-attention
hybrid of its edge fleet, the encoder-decoder whisper-tiny (over stub frame
embeddings) and the VLM internvl2-2b (over stub patch embeddings).

The input-shape suite of the dry-run (`SHAPES`, `shape_supported`,
`adapt_for_shape`) is the JAX package's. `input_specs(cfg, shape, device)`
builds every input of a (config, shape) pair's step as zero tensors on the
device the caller names: under `FakeTensorMode` they are fake and hold no
memory, on "meta" they have shapes only, on "cuda" they are real.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

# public --arch names (hyphenated) -> module name
ALIASES = {
    "qwen3-8b": "qwen3_8b",
    "qwen2-1.5b": "qwen2_1p5b",
    "xlstm-1.3b": "xlstm_1p3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-3-8b": "granite_3_8b",
    "minitron-8b": "minitron_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-2b": "internvl2_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ALIASES:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ALIASES}


# ---------------------------------------------------------------------------
# Input shapes (the reference's suite)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"

    def with_batch(self, batch: int) -> "InputShape":
        return dataclasses.replace(self, global_batch=batch)


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if supported; else the reason for the documented skip."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return ("whisper decoder is pure full-attention with a 30s-audio "
                    "448-token model card; no meaningful sub-quadratic variant "
                    "(documented skip in DESIGN.md)")
    return None


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k needs a sub-quadratic decode state: SSM / hybrid stacks
    are O(1) or windowed, mixtral has its window, and the full-attention
    dense and VLM stacks take a sliding window of 4,096 for this shape
    only (a ring of 4,096 rows in the port's cache)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm") \
            and not cfg.sliding_window:
        return cfg.with_(sliding_window=4096)
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape, device=None) -> dict:
    """Every input of the pair's step as zeros on `device` (fake under an
    active FakeTensorMode): {tokens, targets[, enc_frames][, prefix_embeds]}
    for training, {tokens, prompt_lengths, cache[, ...]} for prefill and
    {tokens, cache} for decode, with the reference's shapes and dtypes.
    Prefill's prompt lengths are the whole sequence; decode's cache
    lengths stand at seq_len - 1, so that the step reads the whole cache
    (or window) and writes its last row."""
    B, S = shape.global_batch, shape.seq_len
    adt = getattr(torch, cfg.dtype)

    def mk(sh, dt):
        return torch.zeros(sh, dtype=dt, device=device)
    out: dict = {}
    prefix = cfg.family == "vlm" and cfg.n_prefix_tokens
    if shape.kind == "train":
        out["tokens"] = mk((B, S), torch.int32)
        out["targets"] = mk((B, S), torch.int32)
        if cfg.family == "encdec":
            e = cfg.encoder
            out["enc_frames"] = mk((B, e.n_ctx, e.d_model), adt)
        if prefix:
            out["prefix_embeds"] = mk((B, cfg.n_prefix_tokens, cfg.d_model),
                                      adt)
        return out
    if shape.kind == "prefill":
        out["tokens"] = mk((B, S), torch.int32)
        out["prompt_lengths"] = torch.full((B,), S, dtype=torch.int32,
                                           device=device)
        cache_len = S
        if cfg.family == "encdec":
            e = cfg.encoder
            out["enc_frames"] = mk((B, e.n_ctx, e.d_model), adt)
        if prefix:
            out["prefix_embeds"] = mk((B, cfg.n_prefix_tokens, cfg.d_model),
                                      adt)
            cache_len = S + cfg.n_prefix_tokens   # the patches are cached
        out["cache"] = transformer.init_cache(cfg, B, cache_len,
                                              device=device)
        return out
    out["tokens"] = mk((B, 1), torch.int32)
    out["cache"] = transformer.init_cache(cfg, B, S, device=device)
    out["cache"]["lengths"].fill_(S - 1)
    return out
