"""The benchmark's arithmetic: the card's peaks, percentiles, and the
operations and bytes that the served tokens need, computed from the
configuration's sizes and the token counts the harness records. Nothing
here reads the program's own estimates.

A model `spec` is a configuration file's "model" group (see
`configs/*.json`).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): bf16 tensor-core
# peak and HBM3 bandwidth, both at the card's full 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
               "fp8": 1}


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def head_dim(spec: dict) -> int:
    return spec["head_dim"] or spec["d_model"] // spec["n_heads"]


def ssm_dims(spec: dict):
    inner = spec["ssm_expand"] * spec["d_model"]
    H = spec["ssm_heads"] or max(1, inner // 64)
    return inner, H, inner // H, spec["ssm_state"]


def attention_layers(spec: dict) -> int:
    """Attention applications a token passes through."""
    if spec["family"] == "hybrid":
        return spec["n_layers"] // spec["shared_attn_every"]
    return spec["n_layers"]


def _attention_block_params(spec: dict) -> int:
    D, hd = spec["d_model"], head_dim(spec)
    attn = D * hd * (2 * spec["n_heads"] + 2 * spec["n_kv_heads"])
    return attn + 3 * D * spec["d_ff"]


def matmul_params(spec: dict) -> int:
    """Matmul weights one token passes through below the unembedding."""
    if spec["family"] == "hybrid":
        inner, H, _, N = ssm_dims(spec)
        mamba = spec["d_model"] * (2 * inner + 2 * N + H) + inner \
            * spec["d_model"]
        return spec["n_layers"] * mamba + attention_layers(spec) \
            * _attention_block_params(spec)
    return spec["n_layers"] * _attention_block_params(spec)


def unembed_params(spec: dict) -> int:
    return spec["d_model"] * spec["vocab_size"]


def attention_flops(spec: dict, keys: int) -> int:
    """QK^T and PV of one query row against `keys` keys, every attention
    layer: 4 hd Hq keys each."""
    return 4 * head_dim(spec) * spec["n_heads"] * keys \
        * attention_layers(spec)


def kv_bytes_per_key(spec: dict) -> int:
    """K and V of one position over every attention layer, in the pool's
    dtype."""
    dt = DTYPE_BYTES[spec["kv_dtype"] or spec["dtype"]]
    return 2 * spec["n_kv_heads"] * head_dim(spec) * dt \
        * attention_layers(spec)


def qo_bytes(spec: dict) -> int:
    """One query row in and its output out, every attention layer."""
    return 2 * spec["n_heads"] * head_dim(spec) \
        * DTYPE_BYTES[spec["dtype"]] * attention_layers(spec)


def step_flops(spec: dict, rows: Iterable) -> float:
    """Useful operations of one model call: rows are (offset, n) runs of n
    new tokens at positions offset..offset+n-1, each run ending in one row
    of logits. 2 x matmul weights a token, attention over each token's
    keys, and the unembedding of each run's last token."""
    total = 0.0
    for off, n in rows:
        total += 2.0 * matmul_params(spec) * n
        keys = n * off + n * (n + 1) // 2
        total += attention_flops(spec, 1) * keys
        total += 2.0 * unembed_params(spec)
    return total


def decode_attention_bytes(spec: dict, offsets: Iterable[int]) -> float:
    """Bytes the paged decode reads need: each row's K/V over its offset +
    1 keys (the new one included), its query in and its output out."""
    return float(sum(kv_bytes_per_key(spec) * (off + 1) + qo_bytes(spec)
                     for off in offsets))


def prefill_attention_bound_s(spec: dict, rows: Sequence) -> float:
    """Least time of one ragged prefill call over chunk rows (offset, n):
    the larger of its operations over the bf16 peak and its bytes (each
    row's K/V of offset + n keys read once, its queries and outputs) over
    HBM bandwidth."""
    flops = sum(attention_flops(spec, 1) * (n * off + n * (n + 1) // 2)
                for off, n in rows)
    nbytes = sum(kv_bytes_per_key(spec) * (off + n) + qo_bytes(spec) * n
                 for off, n in rows)
    return max(flops / PEAK_FLOPS[spec["dtype"]],
               nbytes / PEAK_BYTES_PER_S)


def window_rows(ctx, role: Optional[str] = None, kind: Optional[str] = None
                ) -> List:
    """The traced sub-window's model calls [(role, kind, [(offset, n)])],
    optionally of one role and kind ("decode", "ingest", "prefix")."""
    if ctx.trace is None:
        return []
    return [c for c in ctx.trace.calls
            if (role is None or c[0] == role) and (kind is None
                                                   or c[1] == kind)]


def kernel_seconds(ctx, *needles: str) -> float:
    """Summed device time in the traced sub-window of the kernels whose
    name contains one of `needles`."""
    if ctx.trace is None:
        return 0.0
    return sum(dur for name, _, dur in ctx.trace.kernels
               if any(n in name for n in needles))


def span_seconds(ctx, name: str) -> List[float]:
    """Durations of the spans called `name` that ended in the window."""
    t0, t1 = ctx.window
    return [e - s for s, e in ctx.spans.get(name, ()) if t0 <= e <= t1]
