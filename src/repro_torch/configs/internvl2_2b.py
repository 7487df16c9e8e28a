"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

The InternViT vision encoder is a stub: the caller provides 256 projected
patch embeddings (B, 256, 2048); the InternLM2 language decoder consuming
them IS implemented. [arXiv:2404.16821]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    max_seq_len=524288,
    n_prefix_tokens=256,
    rope_theta=1e6,
    source="arXiv:2404.16821 (InternVL2), InternLM2-1.8B LM backbone",
)
