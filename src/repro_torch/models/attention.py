"""GQA attention against a paged KV pool (PyTorch): decode, one prompt
chunk, and batched ragged chunks.

The read of every path goes through a paged-attention wrapper in
`repro_torch.kernels`, which picks by the tensor's device alone: a CUDA
tensor launches the hand-written CUDA kernel, a CPU tensor runs the kernel's
plain PyTorch version (gather the block table into the contiguous layout,
then masked softmax). `cfg.use_pallas` selects nothing here. K/V writes
update the pools in place.

Projection weights are 2-D: wq (d, Hq*hd), wk/wv (d, Hkv*hd), wo (Hq*hd, d);
biases are flat (H*hd,). `repro_torch.convert` reshapes the JAX package's
(d, H, hd) / (H, hd, d) weights into this layout. Query head h reads KV head
h // q_per_kv.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.paged_decode_attention import ops as pda_ops
from repro_torch.kernels.paged_prefill_attention import ops as ppa_ops
from repro_torch.kernels import runtime
from repro_torch.models import paged_cache as pc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       rope_tables)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, n_q, hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, n_kv, hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, n_kv, hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (n_q, hd, d), in_axis=1, dtype=dtype,
                         device=device),
    }
    p = {k: w.reshape(-1, d) if k == "wo" else w.reshape(d, -1)
         for k, w in p.items()}
    if cfg.qkv_bias:
        for k, n in (("bq", n_q), ("bk", n_kv), ("bv", n_kv)):
            p[k] = torch.zeros(n * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.view(B, S, cfg.n_heads, hd)
    k = k.view(B, S, cfg.n_kv_heads, hd)
    v = v.view(B, S, cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ params["wo"]


def check_paged_support(cfg: ModelConfig) -> None:
    """Raise on configurations the paged path does not serve yet."""
    if cfg.sliding_window:
        raise NotImplementedError(
            "the paged KV cache supports full attention only")
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the paged KV cache does not hold cross-attention caches")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attention logit softcap is not on the paged path (no model of "
            "the dense slice has one)")
    if cfg.kv_quantized:
        raise NotImplementedError(
            "quantized KV pools wait for the quantized-pool slice")


# ---------------------------------------------------------------------------
# Per-call state shared by every layer: write plan, RoPE tables, trimmed
# block rows. The transformer builds it once per model call.
# ---------------------------------------------------------------------------

class PagedCall(NamedTuple):
    dest: torch.Tensor              # (N,) flat pool rows of the writes
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
    rows: torch.Tensor              # (R, P') contiguous read rows
    offsets: torch.Tensor           # (R,) int32; decode: lengths + 1
    lens: Optional[torch.Tensor]    # (R,) int32; decode: None


def as_int32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(-1)
    return runtime.int32_on(v, device)


def _trim(rows: torch.Tensor, live_pages: Optional[int]) -> torch.Tensor:
    return (rows if live_pages is None else rows[:, :live_pages]).contiguous()


def decode_call(cfg: ModelConfig, block_table: torch.Tensor,
                lengths: torch.Tensor, pages: torch.Tensor,
                live_pages: Optional[int] = None,
                active: Optional[torch.Tensor] = None) -> PagedCall:
    rope = None
    if cfg.use_rope:
        rope = rope_tables(lengths[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    dest = pc.token_write_plan(block_table, lengths, pages, active)
    return PagedCall(dest, rope, _trim(block_table, live_pages),
                     lengths + 1, None)


def chunk_call(cfg: ModelConfig, block_rows: torch.Tensor, offsets, lens,
               C: int, pages: torch.Tensor,
               live_pages: Optional[int] = None) -> PagedCall:
    offsets = as_int32(offsets, block_rows.device)
    lens = as_int32(lens, block_rows.device)
    rope = None
    if cfg.use_rope:
        pos = offsets[:, None] + torch.arange(C, device=offsets.device)
        rope = rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    dest = pc.prompt_write_plan(block_rows, offsets, lens, C, pages)
    return PagedCall(dest, rope, _trim(block_rows, live_pages), offsets, lens)


def _qkv_written(cfg, params, x, k_pages, v_pages, call: PagedCall):
    """Project, rotate, and write this call's K/V into the pools."""
    q, k, v = _project_qkv(cfg, params, x)
    if call.rope is not None:
        q = apply_rope(q, tables=call.rope)
        k = apply_rope(k, tables=call.rope)
    n = k.shape[0] * k.shape[1]
    pc.apply_write(k_pages, call.dest, k.reshape(n, *k.shape[2:]))
    pc.apply_write(v_pages, call.dest, v.reshape(n, *v.shape[2:]))
    return q


# ---------------------------------------------------------------------------
# Entry points (the JAX package's signatures; pools are updated in place
# and only the attention output is returned)
# ---------------------------------------------------------------------------

def attention_decode_paged(cfg: ModelConfig, params: dict, x: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, lengths: torch.Tensor,
                           live_pages: Optional[int] = None,
                           active: Optional[torch.Tensor] = None,
                           call: Optional[PagedCall] = None) -> torch.Tensor:
    """Decode step against a paged KV pool (vLLM-style block table).

    x: (B, 1, D); k_pages/v_pages: (n_pages, page, n_kv, hd) this layer's
    pools; block_table: (B, P) page ids (-1 = unmapped); lengths: (B,)
    tokens already cached per slot. Writes each slot's new K/V at position
    `lengths` (rows with `active` False or an unmapped page drop their
    write), then reads positions < lengths + 1 through the paged decode
    wrapper. `live_pages` trims the read to the first block-table columns;
    trimmed columns lie past every slot's length and carry zero weight."""
    check_paged_support(cfg)
    if call is None:
        call = decode_call(cfg, block_table, lengths, k_pages, live_pages,
                           active)
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call)
    out = pda_ops.paged_decode_attention(q, k_pages, v_pages, call.rows,
                                         call.offsets)
    return _out_proj(params, out)


def attention_prefill_chunk_paged(cfg: ModelConfig, params: dict,
                                  x: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_row: torch.Tensor, offset, chunk_len,
                                  live_pages: Optional[int] = None,
                                  call: Optional[PagedCall] = None
                                  ) -> torch.Tensor:
    """One prompt chunk of ONE slot against a paged KV pool.

    x: (1, C, D) right-padded to `chunk_len` valid tokens; block_row: (P,);
    offset: tokens already written for this slot. Writes the chunk's K/V at
    offset..offset+chunk_len-1, then attends each chunk query causally
    within the chunk and against everything the slot already holds, through
    the single-slot paged prefill wrapper. Rows past chunk_len are
    unspecified."""
    check_paged_support(cfg)
    if call is None:
        call = chunk_call(cfg, block_row[None], offset, chunk_len,
                          x.shape[1], k_pages, live_pages)
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call)
    out = ppa_ops.paged_prefill_attention(q, k_pages, v_pages, call.rows[0],
                                          call.offsets, call.lens)
    return _out_proj(params, out)


def attention_prefill_ragged_paged(cfg: ModelConfig, params: dict,
                                   x: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_rows: torch.Tensor, offsets, lens,
                                   live_pages: Optional[int] = None,
                                   call: Optional[PagedCall] = None
                                   ) -> torch.Tensor:
    """R prompt chunks — one per ingesting slot — in a single call.

    x: (R, C, D), row r right-padded to lens[r] valid tokens; block_rows:
    (R, P); offsets/lens: (R,). Writes every row's chunk K/V (distinct slots
    own distinct pages), then attends each row's queries causally within
    its chunk and against everything that slot holds, through the ragged
    paged prefill wrapper. Row r positions past lens[r] are unspecified, as
    are padding rows (lens == 0)."""
    check_paged_support(cfg)
    if call is None:
        call = chunk_call(cfg, block_rows, offsets, lens, x.shape[1],
                          k_pages, live_pages)
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call)
    out = ppa_ops.paged_prefill_attention_ragged(
        q, k_pages, v_pages, call.rows, call.offsets, call.lens)
    return _out_proj(params, out)
