"""Dense KV cache (PyTorch): one (max_len, n_kv, hd) reservation per slot,
or a ring of W rows for a sliding window W.

Layout (the JAX package's `models/cache.py`):

  full KV     : k/v (L, B, S_max, n_kv, hd)
  windowed KV : k/v (L, B, W, n_kv, hd) ring buffer; position p lives in
                row p % W

`lengths` (B,) lives beside the cache (`transformer.init_cache`) and is per
slot, so continuous batching mixes requests at different decode offsets in
one batch; in a ring it stays the absolute position. Writers update the
cache IN PLACE (the JAX package returns new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16, window: int = 0,
                  device=None) -> dict:
    """{"k", "v": (n_layers, batch, size, n_kv, head_dim)} zeros, size the
    window for a ring, else max_len."""
    shape = (n_layers, batch, window or max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_plan(lengths: torch.Tensor, T: int, S: int,
               window: int = 0) -> torch.Tensor:
    """(B*T,) rows of a layer's (B*S, n_kv, hd) flat view that each slot's
    T new tokens land in, starting at its length. As the JAX package's
    `dynamic_update_slice` does, each start is clamped so the T rows fit: a
    slot at length S - T + 1 or more writes rows S - T .. S - 1 (at
    capacity, its last row is overwritten rather than the write dropped).
    In a ring (`window`, S == window) the rows wrap: position p goes to row
    p % window. Every layer of a call shares one plan."""
    B = lengths.shape[0]
    dev = lengths.device
    if window:
        rows = (lengths.long()[:, None] + torch.arange(T, device=dev)) % window
    else:
        start = lengths.long().clamp(0, S - T)
        rows = start[:, None] + torch.arange(T, device=dev)
    return (rows + S * torch.arange(B, device=dev)[:, None]).reshape(-1)


def ring_positions(lengths: torch.Tensor, window: int) -> torch.Tensor:
    """(B, window) int64: the absolute position each ring row holds when
    slot b holds its first lengths[b] positions, the latest ones per row
    (position p in row p % window); negative where no position has reached
    the row yet. The JAX package's decode mask reconstructs positions the
    same way (`abs_pos`)."""
    ki = torch.arange(window, device=lengths.device)[None]
    total = lengths.long()[:, None]
    return ki + torch.div(total - 1 - ki, window,
                          rounding_mode="floor") * window


def update_layer_kv(layer_k: torch.Tensor, layer_v: torch.Tensor,
                    lengths: torch.Tensor, new_k: torch.Tensor,
                    new_v: torch.Tensor, dest: Optional[torch.Tensor] = None):
    """Write new_k/new_v (B, T, n_kv, hd) at per-slot offsets `lengths`
    (clamped, see `write_plan`; `dest` is that plan when the caller built
    it once for every layer), in place, and return (layer_k, layer_v).
    layer_k/layer_v: (B, S, n_kv, hd) with contiguous slots and rows."""
    B, T = new_k.shape[:2]
    S = layer_k.shape[1]
    if dest is None:
        dest = write_plan(lengths, T, S)
    for cache, new in ((layer_k, new_k), (layer_v, new_v)):
        cache.view(B * S, *cache.shape[2:]).index_copy_(
            0, dest, new.reshape(B * T, *new.shape[2:]).to(cache.dtype))
    return layer_k, layer_v
