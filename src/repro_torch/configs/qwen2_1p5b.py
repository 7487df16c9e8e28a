"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA with QKV bias. kv=2 heads cannot split a 16-way model axis — the
divisibility-aware sharding helper replicates KV over `model` (standard GQA
tensor parallelism). [arXiv:2407.10671]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    max_seq_len=524288,
    qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 (Qwen2), 1.5B",
)
