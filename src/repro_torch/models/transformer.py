"""Dense decoder stack over a paged KV cache (PyTorch).

The port of the JAX package's `models/transformer.py` for the dense
attention segments the PICE serving path runs: init, the paged cache, one
prompt chunk, batched ragged chunks, the decode step and the COW fork copy.
Monolithic `prefill_paged`, `promote_slot_paged` (host swap), the dense-cache
entry points and the recurrent, MoE and encoder families wait for their
slices.

Params: {"embed": {"tok", "unembed"}, "segments": [[layer, ...], ...],
"final_norm": {"scale"}, "length_head"?}; each layer is {"norm1": {"scale"},
"attn": {...}, "norm2": {"scale"}, "mlp": {...}} (see attention.py for the
weight layout). The cache is {"lengths": (B,) int32, "block_table": (B, P)
int32, "segments": [{"k_pages", "v_pages": (count, n_pages + 1, page, n_kv,
hd)}]}, the last page of each pool a scratch page that dropped writes land
in (see paged_cache.py); every entry point updates it in place and returns
it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import paged_cache as pc
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.layers import (compute_dtype, dense_init, embed,
                                       init_embedding, init_mlp, mlp, norm,
                                       unembed)


def segments_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    pat = cfg.block_pattern()
    segs: List[Tuple[str, int]] = []
    for kind in pat:
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def check_supported(cfg: ModelConfig) -> None:
    """The dense slice serves attention-only stacks of plain decoder blocks."""
    kinds = {kind for kind, _ in segments_of(cfg)}
    if kinds != {ATTN}:
        raise NotImplementedError(
            f"block kinds {sorted(kinds)} wait for their families' slices; "
            "the port serves dense attention stacks")
    attn_lib.check_paged_support(cfg)


# ---------------------------------------------------------------------------
# Init (the JAX package's shapes and init law, drawn with a torch Generator)
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    d = cfg.d_model
    return {
        "norm1": {"scale": torch.ones(d, device=device)},
        "attn": attn_lib.init_attention(cfg, gen, dtype, device),
        "norm2": {"scale": torch.ones(d, device=device)},
        "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights from `seed`, drawn one tensor at a time on `device`
    and stored in their working dtype (matmul weights and embeddings in
    cfg.dtype, norm scales and the length head in float32)."""
    cfg.validate()
    check_supported(cfg)
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = compute_dtype(cfg)
    p: Dict[str, Any] = {"embed": init_embedding(cfg, gen, dtype, device)}
    p["segments"] = [[_init_layer(cfg, gen, dtype, device)
                      for _ in range(count)] for _, count in segments_of(cfg)]
    p["final_norm"] = {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                           device=device)}
    if cfg.length_buckets:
        p["length_head"] = dense_init(gen, (cfg.d_model, cfg.length_buckets),
                                      device=device)
    return p


def _layers(params: dict):
    for seg in params["segments"]:
        yield from seg


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages_per_seq: int,
                     device=None) -> dict:
    """Per-segment page pools addressed through one shared block table:

      k_pages/v_pages: (count, n_pages + 1, page_size, n_kv, hd); page
                       ids 0..n_pages-1 are the allocator's, the last page
                       takes dropped writes
      block_table:     (batch, max_pages_per_seq) int32, -1 = unmapped
      lengths:         (batch,) int32
    """
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    adt = pc.kv_storage_dtype(cfg.resolved_kv_dtype)
    segs = []
    for _, count in segments_of(cfg):
        shape = (count, n_pages + 1, page_size, cfg.n_kv_heads, hd)
        segs.append({"k_pages": torch.zeros(shape, dtype=adt, device=device),
                     "v_pages": torch.zeros(shape, dtype=adt, device=device)})
    return {"lengths": torch.zeros(batch, dtype=torch.int32, device=device),
            "block_table": torch.full((batch, max_pages_per_seq), -1,
                                      dtype=torch.int32, device=device),
            "segments": segs}


def _pools(cache: dict):
    for seg in cache["segments"]:
        for i in range(seg["k_pages"].shape[0]):
            yield seg["k_pages"][i], seg["v_pages"][i]


def _mlp_residual(cfg: ModelConfig, layer: dict, x: torch.Tensor
                  ) -> torch.Tensor:
    return x + mlp(cfg, layer["mlp"], norm(cfg, layer["norm2"], x))


def _logits_at(cfg: ModelConfig, params: dict, x: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """Logits at each row's last valid position: x (R, C, D) -> (R, V).
    The final norm is per position, so it runs on the selected rows only."""
    R, C = x.shape[:2]
    idx = (lens.long() - 1).clamp(0, C - 1)
    last = x[torch.arange(R, device=x.device), idx]
    return unembed(cfg, params["embed"], norm(cfg, params["final_norm"], last))


def prefill_chunk_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                        cache: dict, slot: int, offset, chunk_len,
                        live_pages: Optional[int] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """Ingest one prompt chunk (tokens: (1, C) right-padded to `chunk_len`
    valid) at batch row `slot`, whose block-table row must already map
    pages through offset + chunk_len tokens. Chunk queries attend causally
    within the chunk and against the slot's already-written context through
    the single-slot paged prefill wrapper; `live_pages` trims the read to
    the covering block-table columns. Returns (logits (1, V) at the last
    valid chunk token, cache)."""
    check_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    C = x.shape[1]
    row = cache["block_table"][slot]
    call = attn_lib.chunk_call(cfg, row[None], offset, chunk_len, C,
                               cache["segments"][0]["k_pages"][0],
                               live_pages)
    for layer, (kp, vp) in zip(_layers(params), _pools(cache)):
        h = attn_lib.attention_prefill_chunk_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), kp, vp, row,
            call.offsets, call.lens, call=call)
        x = _mlp_residual(cfg, layer, x + h)
    logits = _logits_at(cfg, params, x, call.lens)
    cache["lengths"][slot] = (call.offsets + call.lens)[0]
    return logits, cache


def prefill_ragged_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                         cache: dict, slots, offsets, lens,
                         live_pages: Optional[int] = None
                         ) -> Tuple[torch.Tensor, dict]:
    """Batched ragged chunk ingest: R slots' next prompt chunks in ONE call.

    tokens: (R, C) — row r is slot `slots[r]`'s next chunk, right-padded to
    `lens[r]` valid tokens starting at logical position `offsets[r]`;
    slots/offsets/lens: (R,) int tensors or host arrays. Padding rows carry
    slots[r] == batch (out of range): their cache writes drop and their
    block-table gathers clamp to the last row, whose results are discarded.
    Each row's block-table entry must already map pages through
    offsets[r] + lens[r] tokens. Returns (logits (R, V) at each row's last
    valid chunk token, cache); padding rows' logits are unspecified."""
    check_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    C = x.shape[1]
    table = cache["block_table"]
    B = table.shape[0]
    dev = table.device
    slots = attn_lib.as_int32(slots, dev).long()
    block_rows = table[slots.clamp(max=B - 1)]
    call = attn_lib.chunk_call(cfg, block_rows, offsets, lens, C,
                               cache["segments"][0]["k_pages"][0],
                               live_pages)
    for layer, (kp, vp) in zip(_layers(params), _pools(cache)):
        h = attn_lib.attention_prefill_ragged_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), kp, vp,
            block_rows, call.offsets, call.lens, call=call)
        x = _mlp_residual(cfg, layer, x + h)
    logits = _logits_at(cfg, params, x, call.lens)
    # padding rows target index `batch` of a one-longer copy and drop
    ext = torch.cat([cache["lengths"], cache["lengths"].new_zeros(1)])
    ext[slots.clamp(max=B)] = call.offsets + call.lens
    cache["lengths"].copy_(ext[:B])
    return logits, cache


def decode_step_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                      cache: dict, active: Optional[torch.Tensor] = None,
                      live_pages: Optional[int] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, vocab), cache).

    Every layer appends the new token into its page pools through the block
    table and reads through the paged decode wrapper. `active` masks freed
    rows' length advance AND their K/V writes — the engine pushes
    block-table clears lazily, so a freed row's stale table entry may still
    map a COW sibling's pages. `live_pages` bounds the read to the first
    live block-table columns."""
    check_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    lengths = cache["lengths"]
    table = cache["block_table"]
    call = attn_lib.decode_call(cfg, table, lengths,
                                cache["segments"][0]["k_pages"][0],
                                live_pages, active)
    for layer, (kp, vp) in zip(_layers(params), _pools(cache)):
        h = attn_lib.attention_decode_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), kp, vp, table,
            lengths, call=call)
        x = _mlp_residual(cfg, layer, x + h)
    x = norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)[:, 0]
    lengths += 1 if active is None else active.to(lengths.dtype)
    return logits, cache


def fork_slot_paged(cfg: ModelConfig, cache: dict, src_slot: int,
                    dst_slot: int, tail_src_page: int, tail_dst_page: int
                    ) -> dict:
    """Device-side state duplication behind copy-on-write prefix sharing:
    copy the partial tail page of every attention layer (tail_src_page ==
    tail_dst_page is a no-op when the prefix is page-aligned), then mirror
    the source row's cached length. Also serves plain COW page copies: call
    with src_slot == dst_slot and the (old, new) page pair from
    `PageAllocator.cow_page`."""
    check_supported(cfg)
    for seg in cache["segments"]:
        pc.copy_page(seg["k_pages"], tail_src_page, tail_dst_page)
        pc.copy_page(seg["v_pages"], tail_src_page, tail_dst_page)
    cache["lengths"][dst_slot] = cache["lengths"][src_slot]
    return cache

