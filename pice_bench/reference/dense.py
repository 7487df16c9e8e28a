"""Plain float32 reference of a dense GQA decoder (qwen3-8b with per-head
q/k RMSNorm, qwen2-1.5b with q/k/v biases that start at zero): embedding,
`n_layers` pre-norm attention + SwiGLU blocks with rotate-half RoPE, final
RMSNorm, unembedding (the embedding's transpose when tied)."""
from __future__ import annotations

from pice_bench.reference import common


def layer_fns(spec: dict):
    for _ in range(spec["n_layers"]):
        yield (lambda d: common.draw_attention_layer(spec, d),
               lambda p, x, fp8: common.attention_block(spec, p, x, fp8))


def run(spec: dict, seed: int, seqs, device, control: bool = False):
    """See `common.run_sequences`."""
    return common.run_sequences(spec, seed, seqs, device, layer_fns, control)
