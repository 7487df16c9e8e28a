"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base family, 8b geometry as assigned]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    max_seq_len=524288,
    rope_theta=1e7,
    source="hf:ibm-granite/granite-3.0-2b-base (8b geometry)",
)
