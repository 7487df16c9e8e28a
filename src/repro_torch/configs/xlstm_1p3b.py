"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks at 7:1 mLSTM:sLSTM ratio (sLSTM every 8th block);
d_ff=0 — the mLSTM up-projection replaces the FFN. [arXiv:2405.04517]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=524288,
    slstm_at=(0, 8, 16, 24, 32, 40),
    ssm_chunk=256,
    source="arXiv:2405.04517 (xLSTM), 1.3B config",
)
