"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000.

Mamba2 backbone (ssm_state=64) with a shared (weight-tied) attention block
applied every 6 Mamba layers. [arXiv:2411.15242]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    max_seq_len=524288,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,
    source="arXiv:2411.15242 (Zamba2)",
)
