"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

MoE 8 experts top-2, sliding-window attention (W=4096). [arXiv:2401.04088]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=524288,
    sliding_window=4096,
    n_experts=8,
    experts_per_token=2,
    rope_theta=1e6,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
