"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned/distilled Nemotron-4. The 256k vocabulary stresses the embedding
and the unembedding (a 2.1 GB bf16 weight read every decode step).
[arXiv:2407.14679]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    max_seq_len=524288,
    rope_theta=1e6,
    source="arXiv:2407.14679 (Minitron / compact LMs via pruning+distillation)",
)
