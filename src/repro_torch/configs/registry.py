"""Registry of the configurations the PyTorch port serves.

Each config module `repro_torch.configs.<id>` exposes CONFIG, the full-size
configuration with its source. All ten architectures of the JAX package are
listed: the dense GQA decoders (the PICE cloud/edge pairing, granite-3-8b,
minitron-8b), the MoE decoders (qwen3-moe-30b-a3b, and mixtral-8x7b with
its sliding window), the xLSTM stack and the Mamba2 + shared-attention
hybrid of its edge fleet, the encoder-decoder whisper-tiny (over stub frame
embeddings) and the VLM internvl2-2b (over stub patch embeddings).
"""
from __future__ import annotations

import importlib
from typing import Dict

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
