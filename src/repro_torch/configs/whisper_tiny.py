"""whisper-tiny [audio]: enc-dec, conv frontend stubbed. [arXiv:2212.04356]

4L decoder, d_model=384, 6H (kv=6), d_ff=1536, vocab=51865. The mel+conv
frontend is a stub: the caller provides (B, 1500, 384) frame embeddings; the
4-layer transformer encoder over them IS implemented. LayerNorm + GELU +
learned positions per the Whisper architecture.
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    max_seq_len=32768,          # decode_32k shape support (model card: 448)
    use_rope=False,
    use_layernorm=True,
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
                          d_ff=1536, n_ctx=1500),
    source="arXiv:2212.04356 (Whisper); tiny variant",
)
