"""GQA attention (PyTorch): the full sequence (scoring, training), decode
against a dense KV cache, and decode, one prompt chunk and batched ragged
chunks against a paged KV pool (float, or int8 / fp8 with per-(page, kv
head) scales).

The kernel reads go through wrappers in `repro_torch.kernels`, which pick by
the tensor's device alone: a CUDA tensor launches the hand-written CUDA
kernel, a CPU tensor runs the kernel's plain PyTorch version.
`cfg.use_pallas` selects nothing here. The full sequence and, on the card,
monolithic prefill (`prefill_attention`) read through the flash-attention
wrapper, one dense-cache decode token through the decode-attention
wrapper, and every paged read through a paged-attention wrapper (on the
CPU: gather the block table into the contiguous layout, dequantizing a
quantized pool on the way, then masked softmax). Monolithic prefill on the
CPU and multi-token dense decode stay plain PyTorch, as they are plain jnp
in the JAX package. K/V writes update the cache and the pools in place.
Cross-attention (whisper's decoder over its encoder's output, and over the
cross K/V that prefill stores in the dense cache) is plain softmax
attention with float32 logits on every device, as the JAX package's plain
jnp; it has no mask.

Projection weights are 2-D: wq (d, Hq*hd), wk/wv (d, Hkv*hd), wo (Hq*hd, d);
biases are flat (H*hd,). `repro_torch.convert` reshapes the JAX package's
(d, H, hd) / (H, hd, d) weights into this layout. Query head h reads KV head
h // q_per_kv.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_decode_attention import ops as pda_ops
from repro_torch.kernels.paged_decode_attention.ref import (NEG_INF,
                                                           softmax_scale)
from repro_torch.kernels.paged_prefill_attention import ops as ppa_ops
from repro_torch.kernels import runtime
from repro_torch.models import cache as cache_lib
from repro_torch.models import paged_cache as pc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       rope_tables)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device=None, cross: bool = False,
                   kv_d_model: Optional[int] = None) -> dict:
    """Self-attention weights, or with `cross` a decoder layer's
    cross-attention over an encoder of width `kv_d_model` (no q/k-norm)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    kd = kv_d_model or d
    p = {
        "wq": dense_init(gen, (d, n_q, hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (kd, n_kv, hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (kd, n_kv, hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (n_q, hd, d), in_axis=1, dtype=dtype,
                         device=device),
    }
    p = {k: w.reshape(-1, d) if k == "wo" else w.reshape(w.shape[0], -1)
         for k, w in p.items()}
    if cfg.qkv_bias:
        for k, n in (("bq", n_q), ("bk", n_kv), ("bv", n_kv)):
            p[k] = torch.zeros(n * hd, dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """q from x (B, S, D); k, v from kv_x (B, Skv, Dkv), x itself when
    absent (cross-attention passes the encoder's output)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    hd = cfg.resolved_head_dim
    q, k, v = x @ params["wq"], kv_x @ params["wk"], kv_x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.view(B, S, cfg.n_heads, hd)
    k = k.view(B, Skv, cfg.n_kv_heads, hd)
    v = v.view(B, Skv, cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ params["wo"]


def check_paged_support(cfg: ModelConfig) -> None:
    """Raise on configurations the paged path does not serve: as in the JAX
    package, no cross-attention cache (encoder-decoder) and no window."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the paged KV cache does not support cross-attention caches")
    if cfg.sliding_window:
        raise NotImplementedError(
            "the paged KV cache supports full attention only")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attention logit softcap is not on the paged path (no served "
            "model has one)")


# ---------------------------------------------------------------------------
# Plain attention (the JAX package's pure-jnp paths)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B,S,n_kv,hd) -> (B,S,n_q,hd) by repeating each kv head."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q: (B,Tq,N,hd), k/v: (B,Tk,N,hd), mask broadcastable (B,1,Tq,Tk)."""
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(),
                          k.float()) * softmax_scale(q.shape[-1])
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)


# Use q-blocked attention when the logits matrix would exceed this many
# elements per (batch, head) — avoids materializing S x S at long context.
CHUNK_THRESHOLD = 4096 * 4096
CHUNK_BQ = 512


def chunked_sdpa(q, k, v, *, causal: bool, window: int = 0,
                 kv_lengths: Optional[torch.Tensor] = None,
                 softcap: float = 0.0) -> torch.Tensor:
    """Q-blocked attention (a loop over q blocks).

    q: (B,Sq,N,hd), k/v: (B,Sk,N,hd) already head-repeated. Never
    materializes more than (B, bq, N, Sk_eff) logits; with a sliding window
    only a (window + bq) K/V slice is read per block."""
    Sq, hd = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    bq = min(CHUNK_BQ, Sq)
    while Sq % bq:
        bq //= 2
    use_window_slice = bool(window) and (window + bq) <= Sk
    dev = q.device
    outs = []
    for i in range(Sq // bq):
        qi = q[:, i * bq:(i + 1) * bq]
        rows = i * bq + torch.arange(bq, device=dev)
        if use_window_slice:
            start = min(max(i * bq - window, 0), Sk - (window + bq))
            ki = k[:, start:start + window + bq]
            vi = v[:, start:start + window + bq]
            cols = start + torch.arange(window + bq, device=dev)
        else:
            ki, vi = k, v
            cols = torch.arange(Sk, device=dev)
        logits = torch.einsum("bqnh,bknh->bnqk", qi.float(),
                              ki.float()) * softmax_scale(hd)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        m = torch.ones((bq, cols.shape[0]), dtype=torch.bool, device=dev)
        if causal:
            m = m & (cols[None, :] <= rows[:, None])
        if window:
            m = m & (cols[None, :] > rows[:, None] - window)
        m = m[None, None]
        if kv_lengths is not None:
            m = m & (cols[None, None, None, :]
                     < kv_lengths[:, None, None, None])
        logits = torch.where(m, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), vi))
    return torch.cat(outs, dim=1)


def full_or_chunked_sdpa(q, k, v, *, causal: bool, window: int = 0,
                         kv_lengths: Optional[torch.Tensor] = None,
                         softcap: float = 0.0) -> torch.Tensor:
    """Dense SDPA for short sequences, q-blocked for long ones."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq * Sk >= CHUNK_THRESHOLD and Sq > 1:
        return chunked_sdpa(q, k, v, causal=causal, window=window,
                            kv_lengths=kv_lengths, softcap=softcap)
    mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal and Sq == Sk:
        mask = causal_mask(Sq, Sk, window=window, device=q.device)
    if kv_lengths is not None:
        mask = mask & (torch.arange(Sk, device=q.device)[None, None, None, :]
                       < kv_lengths[:, None, None, None])
    return _sdpa(q, k, v, mask, softcap)


def prefill_attention(cfg: ModelConfig, q, k, v,
                      prompt_lengths: torch.Tensor) -> torch.Tensor:
    """Causal attention of monolithic prefill over right-padded prompts.
    q: (B,S,Hq,hd); k/v: (B,S,Hkv,hd), not head-repeated; prompt_lengths
    (B,) int32.

    On a CUDA tensor: the flash-attention wrapper (window and softcap from
    cfg), which takes no lengths. Causal masking alone keeps every row below
    its prompt's length from the padding (its keys all lie at or before it),
    so those rows are the function the CPU path computes; the pad rows
    attend to pad keys. Nothing reads them: the paged writer sends their K/V
    to the scratch page, the dense writer's rows at and past each length
    are overwritten by decode before any read, and the logits are taken at
    each prompt's last valid row. On a CPU tensor: the JAX package's plain
    attention over head-repeated K/V with the padding masked by
    `prompt_lengths`, the arithmetic of its `prefill`."""
    if q.device.type != "cpu":
        return fa_ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window,
                                      softcap=cfg.attn_logit_softcap)
    return full_or_chunked_sdpa(
        q, _repeat_kv(k, cfg.q_per_kv), _repeat_kv(v, cfg.q_per_kv),
        causal=True, window=cfg.sliding_window, kv_lengths=prompt_lengths,
        softcap=cfg.attn_logit_softcap)


def causal_mask(Tq: int, Tk: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,Tq,Tk) bool; window>0 applies sliding-window causality."""
    qi = torch.arange(Tq, device=device)[:, None] + q_offset
    ki = torch.arange(Tk, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None, None]


def _grouped_sdpa(q, k, v, mask, q_per_kv: int, softcap: float = 0.0):
    """GQA attention without materializing repeated K/V.

    q: (B,Tq,Nq,hd) -> grouped (B,Tq,Nkv,g,hd); k/v: (B,Tk,Nkv,hd); mask
    broadcastable to (B,1,Tq,Tk). Products accumulate in float32."""
    if q_per_kv == 1:
        return _sdpa(q, k, v, mask, softcap)
    B, Tq, Nq, hd = q.shape
    Nkv = k.shape[2]
    qg = q.reshape(B, Tq, Nkv, q_per_kv, hd)
    logits = torch.einsum("bqngh,bknh->bngqk", qg.float(),
                          k.float()) * softmax_scale(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknh->bqngh", probs.to(v.dtype), v)
    return out.reshape(B, Tq, Nq, hd)


# ---------------------------------------------------------------------------
# Full sequence (scoring, training) and decode against a dense cache
# ---------------------------------------------------------------------------

def attention_fwd(cfg: ModelConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  segment_mask: Optional[torch.Tensor] = None,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Self-attention over a full sequence. x: (B, S, D); positions
    broadcastable to (B, S), or the precomputed `rope` tables of the call.

    The read goes through the flash-attention wrapper (window and softcap
    from cfg). A `segment_mask` (B,1,S,S), which the kernel does not take,
    runs the plain masked softmax on the CPU and raises on the card: no
    path of the JAX package passes one, training included."""
    S = x.shape[1]
    q, k, v = _project_qkv(cfg, params, x)
    if cfg.use_rope:
        if rope is None:
            rope = rope_tables(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, tables=rope)
        k = apply_rope(k, tables=rope)
    if segment_mask is not None:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "segment masks are not on the card: the flash kernel takes "
                "none, and no path of the JAX package (training included) "
                "passes one")
        mask = causal_mask(S, S, window=cfg.sliding_window,
                           device=x.device) if causal else torch.ones(
            (1, 1, S, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, _repeat_kv(k, cfg.q_per_kv),
                    _repeat_kv(v, cfg.q_per_kv), mask & segment_mask,
                    cfg.attn_logit_softcap)
    else:
        out = fa_ops.flash_attention(q, k, v, causal=causal,
                                     window=cfg.sliding_window,
                                     softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out)


def cross_attention_fwd(cfg: ModelConfig, params: dict, x: torch.Tensor,
                        enc_out: torch.Tensor) -> torch.Tensor:
    """Cross-attention (whisper decoder): x (B, T, D) attends to every row
    of enc_out (B, Se, De), with no mask. Plain softmax attention with
    float32 logits on every device, as the JAX package's plain jnp."""
    q, k, v = _project_qkv(cfg, params, x, kv_x=enc_out)
    return _cross_read(cfg, params, q, k, v)


def cross_attention_cached(cfg: ModelConfig, params: dict, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor
                           ) -> torch.Tensor:
    """Cross-attention of x (B, T, D) against the encoder's projected K/V
    (B, Se, n_kv, hd), which prefill stored in the cache."""
    B, T, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.view(B, T, cfg.n_heads, cfg.resolved_head_dim)
    return _cross_read(cfg, params, q, ck, cv)


def _cross_read(cfg: ModelConfig, params: dict, q, k, v) -> torch.Tensor:
    out = full_or_chunked_sdpa(q, _repeat_kv(k, cfg.q_per_kv),
                               _repeat_kv(v, cfg.q_per_kv), causal=False,
                               softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out)


class DenseCall(NamedTuple):
    """Per-call state of a dense-cache decode, shared by every layer."""
    dest: torch.Tensor              # (B*T,) flat cache rows of the writes
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
    positions: torch.Tensor         # (B, T) query positions
    read_lens: torch.Tensor         # (B,) int32 rows a one-token read covers
    live_rows: Optional[int]        # cache rows a one-token read spans


def dense_decode_call(cfg: ModelConfig, lengths: torch.Tensor, T: int,
                      S: int, live_rows: Optional[int] = None) -> DenseCall:
    """The write plan, RoPE tables and read lengths of T new tokens at
    `lengths` in an S-row cache (a ring of S = cfg.sliding_window rows for
    a windowed stack). `live_rows` (every slot whose output is kept holds
    at most that many rows after the write) narrows the one-token read to
    the cache's first rows, so that the kernel splits only the rows that
    hold keys; dropped rows past every kept slot's length carry no weight.

    In a ring, a one-token read covers min(length + 1, w) rows: after the
    write they hold exactly the positions the window admits (q - w + 1 ..
    q, or 0 .. q before the ring fills), whatever their order, and RoPE was
    applied when each was written."""
    positions = lengths[:, None] + torch.arange(T, device=lengths.device)
    rope = None
    if cfg.use_rope:
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    w = cfg.sliding_window
    read_lens = lengths + 1
    if w:
        read_lens = read_lens.clamp(max=w)
        live_rows = w if live_rows is None else min(live_rows, w)
    return DenseCall(cache_lib.write_plan(lengths, T, S, w), rope, positions,
                     read_lens.to(torch.int32), live_rows)


def attention_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     layer_k: torch.Tensor, layer_v: torch.Tensor,
                     lengths: torch.Tensor,
                     call: Optional[DenseCall] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step. x: (B, T, D) with T new tokens (usually 1).

    layer_k/layer_v: (B, Scache, n_kv, hd), updated in place (a ring of
    Scache = cfg.sliding_window rows for a windowed stack); lengths: (B,)
    int32 tokens already cached; `call` the model call's shared state
    (`dense_decode_call`, built here when absent). Writes the new K/V at
    `lengths` (clamped to fit, or wrapped in a ring; see
    `cache.write_plan`), then reads positions <= each query's own, and
    inside the window: one token through the decode-attention wrapper,
    several through the plain grouped softmax, as the JAX package does.
    Returns (out, layer_k, layer_v).

    A ring's one-token read on the card runs the decode-attention kernel
    over its first min(length + 1, w) rows (`dense_decode_call`), where
    the JAX package sends windowed decode to plain jnp; on the CPU it runs
    the JAX package's plain ring mask, which reconstructs each row's
    position.

    The JAX package's kernel path (use_pallas) drops the logit softcap on
    one-token decode; the port serves no config with a softcap and raises
    on one."""
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attention logit softcap on dense decode is not ported (no "
            "served model has one)")
    T = x.shape[1]
    if call is None:
        call = dense_decode_call(cfg, lengths, T, layer_k.shape[1])
    q, k, v = _project_qkv(cfg, params, x)
    if call.rope is not None:
        q = apply_rope(q, tables=call.rope)
        k = apply_rope(k, tables=call.rope)
    layer_k, layer_v = cache_lib.update_layer_kv(layer_k, layer_v, lengths,
                                                 k, v, call.dest)
    w = cfg.sliding_window
    if T == 1 and not (w and x.device.type == "cpu"):
        live = slice(None, call.live_rows)
        out = da_ops.decode_attention(q.contiguous(), layer_k[:, live],
                                      layer_v[:, live], call.read_lens)
    else:
        qpos = call.positions[:, :, None]                      # (B, T, 1)
        if w:
            abs_pos = cache_lib.ring_positions(lengths + T, w)[:, None]
            mask = (abs_pos <= qpos) & (abs_pos > qpos - w) & (abs_pos >= 0)
        else:
            ki = torch.arange(layer_k.shape[1], device=x.device)
            mask = ki[None, None, :] <= qpos
        out = _grouped_sdpa(q, layer_k, layer_v, mask[:, None], cfg.q_per_kv)
    return _out_proj(params, out), layer_k, layer_v


# ---------------------------------------------------------------------------
# Per-call state shared by every layer: write plan, RoPE tables, trimmed
# block rows. The transformer builds it once per model call.
# ---------------------------------------------------------------------------

class PagedCall(NamedTuple):
    dest: Optional[torch.Tensor]    # (N,) flat pool rows of float writes
    quant: Optional[pc.QuantPlan]   # touched pages of quantized writes
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
    dest = quant = None
    if cfg.kv_quantized:
        quant = pc.token_quant_plan(block_table, lengths, pages, active)
    else:
        dest = pc.token_write_plan(block_table, lengths, pages, active)
    return PagedCall(dest, quant, rope, _trim(block_table, live_pages),
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
    dest = quant = None
    if cfg.kv_quantized:
        quant = pc.prompt_quant_plan(block_rows, offsets, lens, C, pages)
    else:
        dest = pc.prompt_write_plan(block_rows, offsets, lens, C, pages)
    return PagedCall(dest, quant, rope, _trim(block_rows, live_pages),
                     offsets, lens)


def _qkv_written(cfg, params, x, k_pages, v_pages, call: PagedCall,
                 k_scales=None, v_scales=None):
    """Project, rotate, and write this call's K/V into the pools (and, for
    a quantized pool, their scales)."""
    q, k, v = _project_qkv(cfg, params, x)
    if call.rope is not None:
        q = apply_rope(q, tables=call.rope)
        k = apply_rope(k, tables=call.rope)
    n = k.shape[0] * k.shape[1]
    k, v = k.reshape(n, *k.shape[2:]), v.reshape(n, *v.shape[2:])
    if call.quant is not None:
        pc.apply_quant_write(k_pages, k_scales, call.quant, k, cfg.kv_dtype)
        pc.apply_quant_write(v_pages, v_scales, call.quant, v, cfg.kv_dtype)
    else:
        pc.apply_write(k_pages, call.dest, k)
        pc.apply_write(v_pages, call.dest, v)
    return q


# ---------------------------------------------------------------------------
# Entry points (the JAX package's signatures; pools and scales are updated
# in place and only the attention output is returned). With
# cfg.kv_quantized, k/v_scales are the layer's (n_pages, n_kv) f32 scales:
# the writes requantize the touched pages, and the reads go through the
# `_quant` wrappers (on the CPU: dequantize-gather, then attention in f32).
# ---------------------------------------------------------------------------

def attention_decode_paged(cfg: ModelConfig, params: dict, x: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, lengths: torch.Tensor,
                           live_pages: Optional[int] = None,
                           active: Optional[torch.Tensor] = None,
                           call: Optional[PagedCall] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
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
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call, k_scales,
                     v_scales)
    if cfg.kv_quantized:
        out = pda_ops.paged_decode_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, call.rows, call.offsets)
    else:
        out = pda_ops.paged_decode_attention(q, k_pages, v_pages, call.rows,
                                             call.offsets)
    return _out_proj(params, out)


def attention_prefill_chunk_paged(cfg: ModelConfig, params: dict,
                                  x: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_row: torch.Tensor, offset, chunk_len,
                                  live_pages: Optional[int] = None,
                                  call: Optional[PagedCall] = None,
                                  k_scales: Optional[torch.Tensor] = None,
                                  v_scales: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """One prompt chunk of ONE slot against a paged KV pool.

    x: (1, C, D) right-padded to `chunk_len` valid tokens; block_row: (P,);
    offset: tokens already written for this slot. Writes the chunk's K/V at
    offset..offset+chunk_len-1, then attends each chunk query causally
    within the chunk and against everything the slot already holds, through
    the single-slot paged prefill wrapper. Rows past chunk_len come out of
    the attention as zeros."""
    check_paged_support(cfg)
    if call is None:
        call = chunk_call(cfg, block_row[None], offset, chunk_len,
                          x.shape[1], k_pages, live_pages)
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call, k_scales,
                     v_scales)
    if cfg.kv_quantized:
        out = ppa_ops.paged_prefill_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, call.rows[0],
            call.offsets, call.lens)
    else:
        out = ppa_ops.paged_prefill_attention(q, k_pages, v_pages,
                                              call.rows[0], call.offsets,
                                              call.lens)
    return _out_proj(params, out)


def attention_prefill_ragged_paged(cfg: ModelConfig, params: dict,
                                   x: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_rows: torch.Tensor, offsets, lens,
                                   live_pages: Optional[int] = None,
                                   call: Optional[PagedCall] = None,
                                   k_scales: Optional[torch.Tensor] = None,
                                   v_scales: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """R prompt chunks — one per ingesting slot — in a single call.

    x: (R, C, D), row r right-padded to lens[r] valid tokens; block_rows:
    (R, P); offsets/lens: (R,). Writes every row's chunk K/V (distinct slots
    own distinct pages), then attends each row's queries causally within
    its chunk and against everything that slot holds, through the ragged
    paged prefill wrapper. Row r positions past lens[r] come out of the
    attention as zeros, as do padding rows (lens == 0): a MoE layer routes
    them, so their values must not depend on the route."""
    check_paged_support(cfg)
    if call is None:
        call = chunk_call(cfg, block_rows, offsets, lens, x.shape[1],
                          k_pages, live_pages)
    q = _qkv_written(cfg, params, x, k_pages, v_pages, call, k_scales,
                     v_scales)
    if cfg.kv_quantized:
        out = ppa_ops.paged_prefill_attention_ragged_quant(
            q, k_pages, v_pages, k_scales, v_scales, call.rows, call.offsets,
            call.lens)
    else:
        out = ppa_ops.paged_prefill_attention_ragged(
            q, k_pages, v_pages, call.rows, call.offsets, call.lens)
    return _out_proj(params, out)
