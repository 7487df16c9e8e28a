"""PICE's own serving configuration: the cloud LLM + edge SLM fleet pairing.

The paper's testbed pairs Qwen2.5-72B/Llama3-70B on a cloud A100 server with
<8B SLMs on Jetson edge devices, recommending LLM >= 10x SLM. The full-size
pairing here is qwen3-8b in the cloud with qwen2-1.5b at the edge. TINY_*
variants are CPU-runnable models used by the tests and the launcher; they keep
the >=10x size ratio the paper recommends.

The full-size edge fleet is the JAX package's: qwen2-1.5b, the xLSTM stack
xlstm-1.3b and the Mamba2 hybrid zamba2-2.7b, in that order. The TINY fleet
adds the pure Mamba2 TINY_EDGE_C to the two dense SLMs.
"""
from repro_torch.configs.registry import get_config
from repro_torch.models.config import ModelConfig


def cloud_config() -> ModelConfig:
    return get_config("qwen3-8b").with_(length_buckets=16)


def edge_configs() -> dict:
    return {
        "qwen2-1.5b": get_config("qwen2-1.5b"),
        "xlstm-1.3b": get_config("xlstm-1.3b"),
        "zamba2-2.7b": get_config("zamba2-2.7b"),
    }


# ---------------------------------------------------------------------------
# Tiny (CPU-runnable) variants — same families, >=10x cloud/edge param ratio.
# ---------------------------------------------------------------------------

TINY_CLOUD = ModelConfig(
    name="tiny-cloud",
    family="dense",
    n_layers=6,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    head_dim=32,
    d_ff=1024,
    vocab_size=256,          # byte tokenizer
    max_seq_len=2048,
    qk_norm=True,
    length_buckets=16,
    remat=False,
    source="tiny qwen3-style cloud model for CPU testbed",
)

TINY_EDGE_A = ModelConfig(
    name="tiny-edge-a",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    max_seq_len=2048,
    qkv_bias=True,
    remat=False,
    source="tiny qwen2-style edge SLM",
)

TINY_EDGE_B = ModelConfig(
    name="tiny-edge-b",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=192,
    vocab_size=256,
    max_seq_len=2048,
    remat=False,
    source="tiny llama-style edge SLM",
)

TINY_EDGE_C = ModelConfig(
    name="tiny-edge-c",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    max_seq_len=2048,
    ssm_state=16,
    ssm_chunk=64,
    remat=False,
    source="tiny mamba2-style edge SLM (O(1) decode state)",
)

TINY_EDGE_CONFIGS = {
    "tiny-edge-a": TINY_EDGE_A,
    "tiny-edge-b": TINY_EDGE_B,
    "tiny-edge-c": TINY_EDGE_C,
}
