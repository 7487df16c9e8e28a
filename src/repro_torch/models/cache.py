"""Dense KV cache (PyTorch): one (max_len, n_kv, hd) reservation per slot.

Layout (the JAX package's `models/cache.py`):

  full KV : k/v (L, B, S_max, n_kv, hd)

`lengths` (B,) lives beside the cache (`transformer.init_cache`) and is per
slot, so continuous batching mixes requests at different decode offsets in
one batch. Writers update the cache IN PLACE (the JAX package returns new
arrays). The sliding-window ring buffer is not ported: no configuration the
port serves has a window.
"""
from __future__ import annotations

from typing import Optional

import torch


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16, window: int = 0,
                  device=None) -> dict:
    """{"k", "v": (n_layers, batch, max_len, n_kv, head_dim)} zeros."""
    if window:
        raise NotImplementedError(
            "the sliding-window ring cache is not ported (no served config "
            "has a window)")
    shape = (n_layers, batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_plan(lengths: torch.Tensor, T: int, S: int) -> torch.Tensor:
    """(B*T,) rows of a layer's (B*S, n_kv, hd) flat view that each slot's
    T new tokens land in, starting at its length. As the JAX package's
    `dynamic_update_slice` does, each start is clamped so the T rows fit: a
    slot at length S - T + 1 or more writes rows S - T .. S - 1 (at
    capacity, its last row is overwritten rather than the write dropped).
    Every layer of a call shares one plan."""
    B = lengths.shape[0]
    dev = lengths.device
    start = lengths.long().clamp(0, S - T)
    rows = start[:, None] + torch.arange(T, device=dev)
    return (rows + S * torch.arange(B, device=dev)[:, None]).reshape(-1)


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
