"""Model stacks (PyTorch) over a dense or a paged KV cache: dense
attention, MoE, Mamba2 (SSM), xLSTM (mLSTM and sLSTM blocks), the Mamba2 +
shared-attention hybrid (zamba2), the encoder-decoder (whisper) and the VLM
(a decoder over stub patch embeddings).

The port of the JAX package's `models/transformer.py`: init; the
full-sequence `forward` (scoring, training) and `predict_length`; the
dense cache with its monolithic `prefill` and `decode_step`; the paged cache
with monolithic `prefill_paged`, one prompt chunk, batched ragged chunks
(attention-only stacks), the decode step, the COW fork copy and the
host-swap promote. Dense and monolithic paged prefill share
`_prefill_block`, whose `kv_writer` hook alone differs, so both produce the
same activations.

The encoder-decoder family (cfg.family == "encdec") runs `encode` over
stub frame embeddings (B, n_ctx, d_enc): learned positions, pre-norm
blocks with non-causal self-attention (the flash kernel on the card) and a
final norm. Its decoder adds learned positions `dec_pos` and, after each
self-attention, a cross-attention over the encoder's output (plain
PyTorch, as the JAX package's plain jnp); prefill stores the cross K/V in
the dense cache ("cross_k", "cross_v") and decode reads them. The paged
cache refuses the family, as the JAX package's does. A VLM prepends
`prefix_embeds` (B, n_prefix, D) to the token embeddings in `forward` and
`prefill`.

Layers come in segments (`segments_of`): runs of one block kind. ATTN is an
attention + MLP block, MOE an attention + MoE FFN block (`models/moe.py`),
MAMBA2 a Mamba2 block (`models/ssm.py`) and
SHARED_ATTN an application of the one weight-tied attention + MLP block of
a hybrid, whose weights live once in params["shared"] while every
application has its own cache segment. MLSTM and SLSTM are the xLSTM
blocks (`models/xlstm.py`). MAMBA2, MLSTM and SLSTM are the recurrent
kinds: each keeps O(1) per-slot states in place of K/V.

Params: {"embed": {"tok", "unembed"}, "segments": [[layer, ...], ...],
"shared"?: layer, "final_norm": {"scale"}, "length_head"?, "encoder"?:
{"pos", "blocks": [layer, ...], "final_norm"}, "dec_pos"?}; an attention
layer is {"norm1": {"scale"}, "attn": {...}, "norm2": {"scale"}, "mlp":
{...}} (see attention.py for the weight layout), with "norm_x" and
"xattn" added in an encoder-decoder's decoder and "bias" beside each
LayerNorm "scale", a MoE layer the same with
"moe": {"router", "w_gate", "w_up", "w_down"} in place of "mlp", a Mamba2
layer {"norm1":
{"scale"}, "mamba": {...}}, an xLSTM layer {"norm1": {"scale"}, "mlstm" or
"slstm": {...}}, and a SHARED_ATTN segment's list is empty. The
paged cache is {"lengths": (B,) int32, "block_table": (B, P) int32,
"segments": [...]}: an attention segment holds {"k_pages", "v_pages":
(count, n_pages + 1, page, n_kv, hd)}, the last page of each pool a scratch
page that dropped writes land in (see paged_cache.py), and a quantized pool
(cfg.kv_quantized) adds "k_scale", "v_scale": (count, n_pages + 1, n_kv)
f32. The dense cache is {"lengths": (B,) int32, "segments": [...]} with
{"k", "v": (count, B, max_len, n_kv, hd)} for an attention segment, or
(count, B, w, n_kv, hd) rings for a sliding window w (`models/cache.py`),
and an encoder-decoder's {"cross_k", "cross_v": (count, B, n_ctx, n_kv,
hd)} beside them. A
recurrent segment holds the same per-slot states in both caches: Mamba2
{"conv": (count, B, ssm_conv - 1, inner) in cfg.dtype, "ssd": (count, B,
H, P, N) f32}; mLSTM {"C": (count, B, H, hd, hd), "n": (count, B, H, hd),
"m": (count, B, H)} f32; sLSTM {"h", "c", "n", "m": (count, B, d_model)}
f32. A segment's kind, not its keys, tells the two apart
(`attention_segments`, `state_segments`). Every entry point updates its
cache in place and returns it.

The recurrent states follow the JAX package with one departure: a decode
step with an `active` mask leaves inactive rows' states as they were (the
JAX package advances every row, which corrupts a parked prefix that later
forks copy; see `ssm.mamba2_decode`, `xlstm.mlstm_decode`). The ring of a
windowed stack departs too: prefill fills it from each row's own prompt
length, where the JAX package takes the last w rows of the padded buffer
and loses the window of a prompt padded past it (`_ring_writer`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.kernels import runtime
from repro_torch.models import attention as attn_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import paged_cache as pc
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import (ATTN, MAMBA2, MLSTM, MOE,
                                       SHARED_ATTN, SLSTM, ModelConfig)
from repro_torch.models.layers import (apply_rope, compute_dtype, dense_init,
                                       embed, embed_init, init_embedding,
                                       init_mlp, init_norm, mlp, norm,
                                       rope_tables, unembed, working_dtype)


def segments_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    pat = cfg.block_pattern()
    segs: List[Tuple[str, int]] = []
    for kind in pat:
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


SUPPORTED_KINDS = (ATTN, MOE, MAMBA2, MLSTM, SLSTM, SHARED_ATTN)
# the kinds with per-slot recurrent states, and each one's params key
RECURRENT_KINDS = {MAMBA2: "mamba", MLSTM: "mlstm", SLSTM: "slstm"}


def check_supported(cfg: ModelConfig) -> None:
    """The port serves stacks of attention, MoE, Mamba2, xLSTM and
    shared-attention blocks."""
    kinds = {kind for kind, _ in segments_of(cfg)}
    if not kinds <= set(SUPPORTED_KINDS):
        raise NotImplementedError(
            f"block kinds {sorted(kinds - set(SUPPORTED_KINDS))} are not "
            f"ported; the port serves {list(SUPPORTED_KINDS)}")


def is_recurrent(cfg: ModelConfig) -> bool:
    """True for a stack with a recurrent (Mamba2, mLSTM, sLSTM) segment: its
    prefill scans the whole prompt in one call, so it cannot ingest in
    chunks."""
    return any(kind in RECURRENT_KINDS for kind, _ in segments_of(cfg))


def _check_attention_only(cfg: ModelConfig) -> None:
    if is_recurrent(cfg):
        raise ValueError("chunked prefill supports attention-only stacks: a "
                         "recurrent segment's scan cannot resume mid-prompt")


def check_paged_supported(cfg: ModelConfig) -> None:
    """`check_supported` plus the paged path's own restrictions."""
    check_supported(cfg)
    attn_lib.check_paged_support(cfg)


# ---------------------------------------------------------------------------
# Init (the JAX package's shapes and init law, drawn with a torch Generator)
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype,
                device, cross: bool = False) -> dict:
    """One block's params; with `cross` (an encoder-decoder's decoder) also
    its cross-attention and that attention's norm."""
    d = cfg.d_model
    if kind in RECURRENT_KINDS:
        init = {MAMBA2: ssm_lib.init_mamba2, MLSTM: xlstm_lib.init_mlstm,
                SLSTM: xlstm_lib.init_slstm}[kind]
        return {"norm1": init_norm(cfg, d, device),
                RECURRENT_KINDS[kind]: init(cfg, gen, dtype, device)}
    layer = {
        "norm1": init_norm(cfg, d, device),
        "attn": attn_lib.init_attention(cfg, gen, dtype, device),
        "norm2": init_norm(cfg, d, device),
    }
    if kind == MOE:
        layer["moe"] = moe_lib.init_moe(cfg, gen, dtype, device)
    else:
        layer["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device,
                                gated=not cfg.use_layernorm)
    if cross:
        layer["norm_x"] = init_norm(cfg, d, device)
        layer["xattn"] = attn_lib.init_attention(
            cfg, gen, dtype, device, cross=True,
            kv_d_model=cfg.encoder.d_model)
    return layer


def enc_cfg_as_model(cfg: ModelConfig) -> ModelConfig:
    """The encoder's blocks as a model config of their own (no RoPE, no
    window, no q/k-norm), as the JAX package's `_enc_cfg_as_model`."""
    e = cfg.encoder
    return cfg.with_(d_model=e.d_model, n_heads=e.n_heads,
                     n_kv_heads=e.n_kv_heads, d_ff=e.d_ff,
                     n_layers=e.n_layers, use_rope=False, sliding_window=0,
                     qk_norm=False, qkv_bias=cfg.qkv_bias)


def _init_encoder(cfg: ModelConfig, gen: torch.Generator, dtype,
                  device) -> dict:
    ecfg = enc_cfg_as_model(cfg)
    e = cfg.encoder
    return {"pos": embed_init(gen, (e.n_ctx, e.d_model), dtype, device),
            "blocks": [_init_layer(ecfg, ATTN, gen, dtype, device)
                       for _ in range(e.n_layers)],
            "final_norm": init_norm(cfg, e.d_model, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                master: bool = False) -> dict:
    """Random weights from `seed`, drawn one tensor at a time on `device`
    (default the card; see `kernels.runtime.resolve_device`) and stored in
    their working dtype (matmul weights and embeddings in cfg.dtype; norm
    scales, the length head and the leaves `convert` keeps in float32, in
    float32). With `master`, every leaf stays in float32 (cfg.param_dtype):
    the training masters, which `cast_params` casts to the working dtypes
    inside each step; the same draws, unrounded."""
    cfg.validate()
    check_supported(cfg)
    device = runtime.resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = torch.float32 if master else compute_dtype(cfg)
    p: Dict[str, Any] = {"embed": init_embedding(cfg, gen, dtype, device)}
    cross = cfg.family == "encdec"
    segs = []
    for kind, count in segments_of(cfg):
        if kind == SHARED_ATTN:
            if "shared" not in p:
                p["shared"] = _init_layer(cfg, kind, gen, dtype, device)
            segs.append([])         # the weights live in p["shared"]
        else:
            segs.append([_init_layer(cfg, kind, gen, dtype, device, cross)
                         for _ in range(count)])
    p["segments"] = segs
    p["final_norm"] = init_norm(cfg, cfg.d_model, device)
    if cfg.family == "encdec":
        p["encoder"] = _init_encoder(cfg, gen, dtype, device)
        p["dec_pos"] = embed_init(gen, (cfg.max_seq_len, cfg.d_model), dtype,
                                  device)
    if cfg.length_buckets:
        p["length_head"] = dense_init(gen, (cfg.d_model, cfg.length_buckets),
                                      device=device)
    return p


def cast_params(cfg: ModelConfig, params):
    """Float32 master params -> the working params the model runs on, each
    leaf in `layers.working_dtype` (the rule `convert` applies). The cast is
    differentiable, so gradients land on the masters; a leaf already in its
    working dtype is passed through. The JAX package's `_cast_once`
    (`launch/steps.py`)."""
    def cast(tree, name=""):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, name) for v in tree]
        dt = working_dtype(cfg, name)
        return tree if tree.dtype == dt else tree.to(dt)
    return cast(params)


def serving_params(cfg: ModelConfig, params):
    """The working params an engine serves from training masters:
    `cast_params` as plain tensors (no autograd history, no
    requires_grad), one storage each, so that later training does not move
    the engine's weights."""
    def detach(tree):
        if isinstance(tree, dict):
            return {k: detach(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [detach(v) for v in tree]
        return tree.detach().clone()
    return detach(cast_params(cfg, params))


def _walk(cfg: ModelConfig, params: dict, cache: Optional[dict] = None):
    """(kind, layer params, layer cache) of every block in order: the shared
    block's params at each SHARED_ATTN application, and a dict of views of
    the segment's cache leaves at the layer (None without a cache)."""
    for i, (kind, count) in enumerate(segments_of(cfg)):
        seg = params["segments"][i]
        segc = None if cache is None else cache["segments"][i]
        for j in range(count):
            layer = params["shared"] if kind == SHARED_ATTN else seg[j]
            yield kind, layer, (None if segc is None
                                else {k: v[j] for k, v in segc.items()})


def attention_segments(cfg: ModelConfig, cache: dict) -> List[dict]:
    """The cache's attention segments (K/V rows or page pools)."""
    return [seg for (kind, _), seg in zip(segments_of(cfg), cache["segments"])
            if kind not in RECURRENT_KINDS]


def state_segments(cfg: ModelConfig, cache: dict) -> List[dict]:
    """The cache's recurrent segments (per-slot states)."""
    return [seg for (kind, _), seg in zip(segments_of(cfg), cache["segments"])
            if kind in RECURRENT_KINDS]


def _first_attention(cfg: ModelConfig, cache: dict) -> Optional[dict]:
    """The first attention segment of a cache (None for a purely recurrent
    stack): the per-call plans are built from its shapes."""
    segs = attention_segments(cfg, cache)
    return segs[0] if segs else None


def _recurrent_states(cfg: ModelConfig, kind: str, count: int, batch: int,
                      device) -> dict:
    """A recurrent segment's per-slot states, zeros as in the JAX package's
    `init_cache`: Mamba2's conv tail in cfg.dtype and SSD state in float32,
    the mLSTM's C, n, m and the sLSTM's h, c, n, m in float32. A prefill
    overwrites a slot's states whatever they held."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == MAMBA2:
        inner, H, P, N = ssm_lib.ssm_dims(cfg)
        return {"conv": torch.zeros((count, batch, cfg.ssm_conv - 1, inner),
                                    dtype=compute_dtype(cfg), device=device),
                "ssd": torch.zeros((count, batch, H, P, N), **f32)}
    if kind == MLSTM:
        _, H, hd = xlstm_lib.mlstm_dims(cfg)
        return {"C": torch.zeros((count, batch, H, hd, hd), **f32),
                "n": torch.zeros((count, batch, H, hd), **f32),
                "m": torch.zeros((count, batch, H), **f32)}
    return {k: torch.zeros((count, batch, cfg.d_model), **f32)
            for k in xlstm_lib.SLSTM_STATE}


# ---------------------------------------------------------------------------
# Shared layer bodies
# ---------------------------------------------------------------------------

def _ffn_aux(cfg: ModelConfig, layer: dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's FFN on norm2(x): the SwiGLU MLP, or for a MOE layer
    the MoE FFN, whose balance loss comes second (None for an MLP)."""
    xin = norm(cfg, layer["norm2"], x)
    if "moe" in layer:
        h, aux = moe_lib.moe_fwd(cfg, layer["moe"], xin)
        return x + h, aux
    return x + mlp(cfg, layer["mlp"], xin), None


def _ffn_residual(cfg: ModelConfig, layer: dict, x: torch.Tensor
                  ) -> torch.Tensor:
    return _ffn_aux(cfg, layer, x)[0]


def _recurrent_block(cfg: ModelConfig, kind: str, layer: dict,
                     x: torch.Tensor, c: Optional[dict] = None
                     ) -> torch.Tensor:
    """One recurrent block over whole sequences (x: (B, S, D)), its scan
    started from the block's initial state, as each scan of the JAX
    package's prefill starts; with `c` (views of the B cache rows' state
    leaves), its final states are copied there. The scan covers all S rows,
    padding included: the engine prefills a recurrent stack unpadded."""
    xin = norm(cfg, layer["norm1"], x)
    p = layer[RECURRENT_KINDS[kind]]
    if kind == MAMBA2:
        out, conv, ssd = ssm_lib.mamba2_fwd(cfg, p, xin, return_state=True)
        final = {"conv": conv, "ssd": ssd}
    elif kind == MLSTM:
        out, final = xlstm_lib.mlstm_fwd(cfg, p, xin, return_state=True)
    else:
        out, final = xlstm_lib.slstm_fwd(cfg, p, xin, return_state=True)
    for k, leaf in (c or {}).items():
        leaf.copy_(final[k])
    return x + out


def _recurrent_decode(cfg: ModelConfig, kind: str, layer: dict,
                      x: torch.Tensor, c: dict,
                      active: Optional[torch.Tensor]) -> torch.Tensor:
    """One recurrent block's decode step on x (B, 1, D), its states `c`
    updated in place where `active` (all rows without one)."""
    xin = norm(cfg, layer["norm1"], x)
    p = layer[RECURRENT_KINDS[kind]]
    if kind == MAMBA2:
        out, _, _ = ssm_lib.mamba2_decode(cfg, p, xin, c["conv"], c["ssd"],
                                          active)
    elif kind == MLSTM:
        out = xlstm_lib.mlstm_decode(cfg, p, xin, c, active)
    else:
        out = xlstm_lib.slstm_decode(cfg, p, xin, c, active)
    return x + out


def _logits_at(cfg: ModelConfig, params: dict, x: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """Logits at each row's last valid position: x (R, C, D) -> (R, V).
    The final norm is per position, so it runs on the selected rows only."""
    R, C = x.shape[:2]
    idx = (lens.long() - 1).clamp(0, C - 1)
    last = x[torch.arange(R, device=x.device), idx]
    return unembed(cfg, params["embed"], norm(cfg, params["final_norm"], last))


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """The call's RoPE tables at `positions`, shared by every layer."""
    if not cfg.use_rope:
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Full sequence (scoring)
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, kind: str, layer: dict,
               positions: torch.Tensor, rope, x: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None, causal: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over whole sequences (no cache) -> (x, the MoE balance
    loss or None); an encoder-decoder's decoder block attends to `enc_out`
    after its self-attention; an encoder block is not `causal`."""
    if kind in RECURRENT_KINDS:
        return _recurrent_block(cfg, kind, layer, x), None
    h = attn_lib.attention_fwd(cfg, layer["attn"],
                               norm(cfg, layer["norm1"], x), positions,
                               causal=causal, rope=rope)
    x = x + h
    if enc_out is not None and "xattn" in layer:
        x = x + attn_lib.cross_attention_fwd(
            cfg, layer["xattn"], norm(cfg, layer["norm_x"], x), enc_out)
    return _ffn_aux(cfg, layer, x)


def _run_layer(cfg: ModelConfig, kind: str, layer: dict, positions, rope,
               x: torch.Tensor, enc_out=None, causal: bool = True):
    """`_layer_fwd`, rematerialized in the backward while autograd records
    and cfg.remat is set (`torch.utils.checkpoint`, as the JAX package's
    `jax.checkpoint` over each layer)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch_checkpoint.checkpoint(_layer_fwd, cfg, kind, layer,
                                           positions, rope, x, enc_out,
                                           causal, use_reentrant=False)
    return _layer_fwd(cfg, kind, layer, positions, rope, x, enc_out, causal)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, n, d_enc) stub embeddings, n <= n_ctx -> the encoder's
    output (B, n, d_enc). `params` is params["encoder"]. Learned positions
    pos[:n], then pre-norm blocks with non-causal self-attention (the
    flash-attention wrapper: its kernel on the card) and the GELU MLP,
    then the final norm. The frames must come in cfg.dtype: the JAX
    package runs the encoder in the frames' own dtype, and the port's
    layers compute in cfg.dtype only, so it refuses any other."""
    if frames.dtype != compute_dtype(cfg):
        raise ValueError(f"{cfg.name}: enc_frames must be "
                         f"{compute_dtype(cfg)}, got {frames.dtype}")
    ecfg = enc_cfg_as_model(cfg)
    n = frames.shape[1]
    x = frames + params["pos"][None, :n]
    positions = torch.arange(n, device=x.device)[None]
    for layer in params["blocks"]:
        x, _ = _run_layer(ecfg, ATTN, layer, positions, None, x,
                          causal=False)
    return norm(ecfg, params["final_norm"], x)


def _embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor],
                  enc_frames: Optional[torch.Tensor]):
    """The token embeddings behind a VLM's `prefix_embeds`, plus an
    encoder-decoder's positions dec_pos[:S] -> (x, the encoder's output or
    None). An encoder-decoder needs its frames; other families take none."""
    x = embed(cfg, params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.family != "encdec":
        return x, None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass enc_frames "
                         f"(B, n_ctx, {cfg.encoder.d_model}) frame embeddings")
    enc_out = encode(cfg, params["encoder"], enc_frames)
    return x + params["dec_pos"][None, :x.shape[1]], enc_out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """tokens: (B, S) int -> (logits (B, S', V), aux_loss[, hidden]).

    prefix_embeds: a VLM's stub patch embeddings (B, n_prefix, D), put
    before the tokens (S' = n_prefix + S); enc_frames: an encoder-decoder's
    stub frame embeddings (B, n, d_enc), which it needs. With
    `return_hidden` the final-normed hidden states (B, S', D) come third.

    Every attention layer reads through the flash-attention wrapper
    (causal, with cfg's window and softcap), every Mamba2 layer scans
    through the SSD-scan wrapper, every xLSTM layer runs its plain PyTorch
    cell, every MoE FFN routes through `moe.moe_fwd`. The aux loss is the
    sum of the MoE layers' balance losses, as in the JAX package (zero
    for a stack without MoE layers).

    Differentiable: on the card the three wrappers' backward kernels carry
    the gradient through the norms, the attention and the scan. While
    autograd records (training) and cfg.remat is set, each block is
    rematerialized in the backward (`torch.utils.checkpoint`, as the JAX
    package's `jax.checkpoint` over each layer), so only the blocks'
    inputs stay alive between the two passes."""
    check_supported(cfg)
    x, enc_out = _embed_inputs(cfg, params, tokens, prefix_embeds,
                               enc_frames)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    rope = _rope(cfg, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, layer, _ in _walk(cfg, params):
        x, aux = _run_layer(cfg, kind, layer, positions, rope, x, enc_out)
        if aux is not None:
            aux_total = aux_total + aux
    x = norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    if return_hidden:
        return logits, aux_total, x
    return logits, aux_total


def predict_length(cfg: ModelConfig, params: dict, hidden: torch.Tensor
                   ) -> torch.Tensor:
    """PICE's response-length head: mean-pooled hidden (B, S, D) -> bucket
    logits (B, length_buckets), in float32."""
    pooled = hidden.float().mean(dim=1)
    return pooled @ params["length_head"].float()


# ---------------------------------------------------------------------------
# Dense cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """{"lengths": (batch,) int32, "segments": [...]}, zeros: an attention
    segment's {"k", "v": (count, batch, max_len, n_kv, hd)} in cfg.dtype,
    rings of cfg.sliding_window rows for a windowed stack
    (`cache.init_kv_cache`), with an encoder-decoder's cross K/V
    {"cross_k", "cross_v": (count, batch, n_ctx, n_kv, hd)} beside them; a
    recurrent segment's per-slot states."""
    check_supported(cfg)
    segs = []
    for kind, count in segments_of(cfg):
        if kind in RECURRENT_KINDS:
            segs.append(_recurrent_states(cfg, kind, count, batch, device))
            continue
        seg = cache_lib.init_kv_cache(
            count, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
            compute_dtype(cfg), window=cfg.sliding_window, device=device)
        if cfg.family == "encdec":
            cross = cache_lib.init_kv_cache(
                count, batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
                cfg.resolved_head_dim, compute_dtype(cfg), device=device)
            seg["cross_k"], seg["cross_v"] = cross["k"], cross["v"]
        segs.append(seg)
    return {"lengths": torch.zeros(batch, dtype=torch.int32, device=device),
            "segments": segs}


KVWriter = Callable[[torch.Tensor, torch.Tensor], None]


def _prefill_block(cfg: ModelConfig, layer: dict, x: torch.Tensor, rope,
                   prompt_lengths: torch.Tensor, kv_writer: KVWriter,
                   enc_out: Optional[torch.Tensor] = None,
                   c: Optional[dict] = None) -> torch.Tensor:
    """One layer over a whole right-padded prompt, causal
    (`attention.prefill_attention`: the flash kernel on the card; on the
    CPU plain attention with the padding masked by `prompt_lengths`, as in
    the JAX package). Rows below each prompt length are the same function
    on both; pad rows differ and nothing reads them. `kv_writer(k, v)`
    stores the layer's K/V (B, S, n_kv, hd): the dense writer into the
    cache rows, the paged one through the block table; the compute is
    shared, so dense and paged prefill give the same activations. An
    encoder-decoder's block then projects `enc_out` into its cross K/V,
    stores them in the layer's dense cache views `c`, and attends to them.
    """
    xin = norm(cfg, layer["norm1"], x)
    q, k, v = attn_lib._project_qkv(cfg, layer["attn"], xin)
    if rope is not None:
        q = apply_rope(q, tables=rope)
        k = apply_rope(k, tables=rope)
    h = attn_lib.prefill_attention(cfg, q, k, v, prompt_lengths)
    x = x + attn_lib._out_proj(layer["attn"], h)
    kv_writer(k, v)
    if enc_out is not None and "xattn" in layer:
        xin2 = norm(cfg, layer["norm_x"], x)
        _, ck, cv = attn_lib._project_qkv(cfg, layer["xattn"], xin2,
                                          kv_x=enc_out)
        c["cross_k"].copy_(ck)
        c["cross_v"].copy_(cv)
        x = x + attn_lib.cross_attention_cached(cfg, layer["xattn"], xin2,
                                                ck, cv)
    return _ffn_residual(cfg, layer, x)


def _dense_writer(ck: torch.Tensor, cv: torch.Tensor) -> KVWriter:
    """Rows [0, S) of the cache take the prompt's K/V and rows past S are
    zeroed, as the JAX package's `zeros_like(c).at[:, :S].set(k)` leaves
    them."""
    def write(k, v):
        S = k.shape[1]
        for c, new in ((ck, k), (cv, v)):
            c[:, :S] = new.to(c.dtype)
            c[:, S:] = 0
    return write


def _ring_writer(ck: torch.Tensor, cv: torch.Tensor,
                 prompt_lengths: torch.Tensor, window: int) -> KVWriter:
    """The ring of each row b holds positions [max(0, L - w), L) of its own
    prompt length L = prompt_lengths[b], position p in row p % w, and zeros
    in the rows no position has reached (decode never reads them: it reads
    min(length + 1, w) rows, or masks by position).

    A departure from the JAX package, which keeps the last w rows of the
    padded buffer: a prompt padded to S >= w loses positions L - w .. S - w
    - 1 there, and pad rows take their ring rows."""
    pos = cache_lib.ring_positions(prompt_lengths, window)      # (B, w)
    valid = (pos >= 0)[:, :, None, None]
    src = pos.clamp(min=0)

    def write(k, v):
        idx = src[:, :, None, None].expand(-1, -1, *k.shape[2:])
        for c, new in ((ck, k), (cv, v)):
            ring = torch.gather(new, 1, idx)
            c.copy_(torch.where(valid, ring, ring.new_zeros(())).to(c.dtype))
    return write


def _fit_cross(cfg: ModelConfig, cache: dict, n: int) -> None:
    """Size the cache's cross K/V to an encoder output of n rows: the JAX
    package's prefill replaces the leaves with the encoder's K/V, whatever
    their rows, and decode attends to all of them."""
    for seg in attention_segments(cfg, cache):
        for key in ("cross_k", "cross_v"):
            leaf = seg[key]
            if leaf.shape[2] != n:
                seg[key] = leaf.new_zeros(leaf.shape[:2] + (n,)
                                          + leaf.shape[3:])


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, prompt_lengths=None,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Process right-padded prompts (tokens: (B, S)), fill the dense cache's
    B rows and return each prompt's last-position logits (B, V).

    A VLM's `prefix_embeds` (B, n_prefix, D) go before the tokens: the cache
    holds n_prefix + S positions and each length grows by n_prefix. An
    encoder-decoder encodes `enc_frames` (B, n, d_enc), adds dec_pos[:S]
    and stores each layer's cross K/V (B, n, n_kv, hd) in the cache (whose
    cross leaves take n rows).

    prompt_lengths: (B,) valid counts (default S). The cache may be a view
    of some rows of a larger one (the engine passes one slot's rows): the
    rows are written in place, K/V at positions [0, S) and zeros past S
    (a ring: each row's last w positions of its own prompt length, see
    `_ring_writer`), the recurrent states after all S positions from the initial state
    (padding included, as in the JAX package: the engine prefills a
    recurrent stack unpadded), and its lengths are set to
    prompt_lengths."""
    check_supported(cfg)
    x, enc_out = _embed_inputs(cfg, params, tokens, prefix_embeds,
                               enc_frames)
    B, S = x.shape[:2]
    if prompt_lengths is None:
        plens = attn_lib.as_int32([S] * B, x.device)
    else:
        plens = attn_lib.as_int32(prompt_lengths, x.device)
        if prefix_embeds is not None:
            plens = plens + prefix_embeds.shape[1]
    if enc_out is not None:
        _fit_cross(cfg, cache, enc_out.shape[1])
    rope = _rope(cfg, torch.arange(S, device=x.device)[None])
    for kind, layer, c in _walk(cfg, params, cache):
        if kind in RECURRENT_KINDS:
            x = _recurrent_block(cfg, kind, layer, x, c)
            continue
        writer = (_ring_writer(c["k"], c["v"], plens, cfg.sliding_window)
                  if cfg.sliding_window else _dense_writer(c["k"], c["v"]))
        x = _prefill_block(cfg, layer, x, rope, plens, writer, enc_out, c)
    logits = _logits_at(cfg, params, x, plens)
    cache["lengths"].copy_(plens)
    return logits, cache


def _advance_lengths(lengths: torch.Tensor,
                     active: Optional[torch.Tensor]) -> None:
    """Post-decode length update, in place: only active rows consumed a
    token. Without the mask, freed slots' lengths drift past max_len
    between requests."""
    lengths += 1 if active is None else active.to(lengths.dtype)


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict, active: Optional[torch.Tensor] = None,
                live_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, vocab), cache).

    Every attention layer writes the new token's K/V at each row's length
    (clamped to fit, inactive rows included: their writes land in freed
    space) and reads through the decode-attention wrapper; every recurrent
    layer advances its states in place. `active` (B,) bool masks the
    length advance and the recurrent state updates. `live_rows` bounds the read to the
    cache's first rows (at least every active row's length + 1; inactive
    rows' logits are then unspecified). The write plan, RoPE tables and
    read lengths are built once per call. An encoder-decoder adds
    dec_pos[min(length, max_seq_len - 1)] to each row's token and, after
    each self-attention, attends to the cross K/V its prefill stored."""
    check_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    lengths = cache["lengths"]
    if cfg.family == "encdec":
        pos = lengths.long().clamp(0, cfg.max_seq_len - 1)
        x = x + params["dec_pos"][pos][:, None]
    attn = _first_attention(cfg, cache)
    call = None if attn is None else attn_lib.dense_decode_call(
        cfg, lengths, 1, attn["k"].shape[2], live_rows)
    for kind, layer, c in _walk(cfg, params, cache):
        if kind in RECURRENT_KINDS:
            x = _recurrent_decode(cfg, kind, layer, x, c, active)
            continue
        h, _, _ = attn_lib.attention_decode(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), c["k"], c["v"],
            lengths, call=call)
        x = x + h
        if "cross_k" in c and "xattn" in layer:
            x = x + attn_lib.cross_attention_cached(
                cfg, layer["xattn"], norm(cfg, layer["norm_x"], x),
                c["cross_k"], c["cross_v"])
        x = _ffn_residual(cfg, layer, x)
    x = norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)[:, 0]
    _advance_lengths(lengths, active)
    return logits, cache


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

    cfg.kv_quantized stores the pools as int8 / float8_e4m3fn and adds the
    per-(page, kv head) f32 scales k_scale/v_scale: (count, n_pages + 1,
    n_kv), initialised to ones so unwritten pages dequantize to zeros.
    Recurrent segments keep their O(1) per-slot states, as in the dense
    cache.
    """
    check_paged_supported(cfg)
    hd = cfg.resolved_head_dim
    adt = pc.kv_storage_dtype(cfg.resolved_kv_dtype)
    segs = []
    for kind, count in segments_of(cfg):
        if kind in RECURRENT_KINDS:
            segs.append(_recurrent_states(cfg, kind, count, batch, device))
            continue
        shape = (count, n_pages + 1, page_size, cfg.n_kv_heads, hd)
        seg = {"k_pages": torch.zeros(shape, dtype=adt, device=device),
               "v_pages": torch.zeros(shape, dtype=adt, device=device)}
        if cfg.kv_quantized:
            for k in ("k_scale", "v_scale"):
                seg[k] = torch.ones(shape[:2] + (cfg.n_kv_heads,),
                                    dtype=torch.float32, device=device)
        segs.append(seg)
    return {"lengths": torch.zeros(batch, dtype=torch.int32, device=device),
            "block_table": torch.full((batch, max_pages_per_seq), -1,
                                      dtype=torch.int32, device=device),
            "segments": segs}


def prefill_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, slot: int, prompt_len
                  ) -> Tuple[torch.Tensor, dict]:
    """Prefill one request (tokens: (1, S) right-padded) straight into the
    paged cache at batch row `slot`, whose block-table row must already map
    pages for `prompt_len` tokens: the layers run `_prefill_block` as dense
    prefill does, and each writes its K/V at positions [0, prompt_len)
    through the block table (the padding goes to the scratch page); the
    recurrent layers scan all S positions from their initial states and
    store their final states in row `slot`. Sets lengths[slot] = prompt_len; a quantized pool requantizes
    the pages the prompt covers. Returns (logits (1, V), cache)."""
    check_paged_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    S = x.shape[1]
    plen = attn_lib.as_int32(prompt_len if isinstance(prompt_len, torch.Tensor)
                             else [int(prompt_len)], x.device)
    rope = _rope(cfg, torch.arange(S, device=x.device)[None])
    row = cache["block_table"][slot]
    attn = _first_attention(cfg, cache)
    if attn is not None:
        offs, pages = torch.zeros_like(plen), attn["k_pages"][0]
        if cfg.kv_quantized:
            plan = pc.prompt_quant_plan(row[None], offs, plen, S, pages)
        else:
            dest = pc.prompt_write_plan(row[None], offs, plen, S, pages)

    def writer(c):
        def write(k, v):
            if cfg.kv_quantized:
                pc.apply_quant_write(c["k_pages"], c["k_scale"], plan, k[0],
                                     cfg.kv_dtype)
                pc.apply_quant_write(c["v_pages"], c["v_scale"], plan, v[0],
                                     cfg.kv_dtype)
            else:
                pc.apply_write(c["k_pages"], dest, k[0])
                pc.apply_write(c["v_pages"], dest, v[0])
        return write

    for kind, layer, c in _walk(cfg, params, cache):
        if kind in RECURRENT_KINDS:
            x = _recurrent_block(cfg, kind, layer, x,
                                 {k: v[slot:slot + 1] for k, v in c.items()})
            continue
        x = _prefill_block(cfg, layer, x, rope, plen, writer(c))
    logits = _logits_at(cfg, params, x, plen)
    cache["lengths"][slot] = plen[0]
    return logits, cache


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
    valid chunk token, cache). Attention-only stacks (a recurrent
    segment's scan cannot resume mid-prompt)."""
    check_paged_supported(cfg)
    _check_attention_only(cfg)
    x = embed(cfg, params["embed"], tokens)
    C = x.shape[1]
    row = cache["block_table"][slot]
    call = attn_lib.chunk_call(cfg, row[None], offset, chunk_len, C,
                               cache["segments"][0]["k_pages"][0],
                               live_pages)
    for _, layer, c in _walk(cfg, params, cache):
        h = attn_lib.attention_prefill_chunk_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), c["k_pages"],
            c["v_pages"], row, call.offsets, call.lens, call=call,
            k_scales=c.get("k_scale"), v_scales=c.get("v_scale"))
        x = _ffn_residual(cfg, layer, x + h)
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
    valid chunk token, cache); padding rows' logits are unspecified.
    Attention-only stacks, as `prefill_chunk_paged`."""
    check_paged_supported(cfg)
    _check_attention_only(cfg)
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
    for _, layer, c in _walk(cfg, params, cache):
        h = attn_lib.attention_prefill_ragged_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), c["k_pages"],
            c["v_pages"], block_rows, call.offsets, call.lens, call=call,
            k_scales=c.get("k_scale"), v_scales=c.get("v_scale"))
        x = _ffn_residual(cfg, layer, x + h)
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

    Every attention layer appends the new token into its page pools through
    the block table and reads through the paged decode wrapper; every
    recurrent layer advances its per-slot states in place. `active` masks
    freed rows' length advance, their K/V writes — the engine pushes
    block-table clears lazily, so a freed row's stale table entry may still
    map a COW sibling's pages — and their recurrent state updates (a parked
    prefix row keeps the state its forks copy). `live_pages` bounds the read to the
    first live block-table columns."""
    check_paged_supported(cfg)
    x = embed(cfg, params["embed"], tokens)
    lengths = cache["lengths"]
    table = cache["block_table"]
    attn = _first_attention(cfg, cache)
    call = None if attn is None else attn_lib.decode_call(
        cfg, table, lengths, attn["k_pages"][0], live_pages, active)
    for kind, layer, c in _walk(cfg, params, cache):
        if kind in RECURRENT_KINDS:
            x = _recurrent_decode(cfg, kind, layer, x, c, active)
            continue
        h = attn_lib.attention_decode_paged(
            cfg, layer["attn"], norm(cfg, layer["norm1"], x), c["k_pages"],
            c["v_pages"], table, lengths, call=call,
            k_scales=c.get("k_scale"), v_scales=c.get("v_scale"))
        x = _ffn_residual(cfg, layer, x + h)
    x = norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)[:, 0]
    _advance_lengths(lengths, active)
    return logits, cache


def fork_slot_paged(cfg: ModelConfig, cache: dict, src_slot: int,
                    dst_slot: int, tail_src_page: int, tail_dst_page: int
                    ) -> dict:
    """Device-side state duplication behind copy-on-write prefix sharing:
    copy the partial tail page of every attention layer (tail_src_page ==
    tail_dst_page is a no-op when the prefix is page-aligned), with its
    scales in a quantized pool, and the source row's recurrent states into
    the destination row, then mirror the source row's cached length. Also
    serves plain COW page copies: call with src_slot == dst_slot and the
    (old, new) page pair from `PageAllocator.cow_page`."""
    check_paged_supported(cfg)
    for seg in attention_segments(cfg, cache):
        for leaf in seg.values():
            pc.copy_page(leaf, tail_src_page, tail_dst_page)
    if src_slot != dst_slot:
        for seg in state_segments(cfg, cache):
            for leaf in seg.values():
                leaf[:, dst_slot].copy_(leaf[:, src_slot])
    cache["lengths"][dst_slot] = cache["lengths"][src_slot]
    return cache


def promote_slot_paged(cfg: ModelConfig, cache: dict, upload_ids, payloads,
                       slot: int, ctx_len: int) -> dict:
    """Swap-in (host-tier promote): write a demoted request's snapshotted
    pages back into every attention segment's pools, in place, and restore
    its cached length, so decode re-enters directly — no replay.

    upload_ids: host sequence of U physical page ids (ints); an id equal to
    n_pages (the scratch page) stands for the JAX package's dropped padding
    id, and any other id outside [0, n_pages] raises before anything
    reaches the device. payloads: one dict per attention segment holding
    k_pages/v_pages (count, U, page, n_kv, hd), and k_scale/v_scale
    (count, U, n_kv) for a quantized pool, cast to the pool's storage dtype
    and written byte for byte (one index_copy_ a leaf, through uint8 views:
    PyTorch indexes no float8 tensor in place on the CPU). The block table
    is pushed separately by the engine's host mirror. Recurrent segments
    pass through untouched (the engine gates swap to attention-only
    stacks)."""
    check_paged_supported(cfg)
    segs = attention_segments(cfg, cache)
    ids = [int(p) for p in upload_ids]
    if ids:
        if len(payloads) != len(segs):
            raise ValueError(f"{len(payloads)} payloads for {len(segs)} "
                             f"attention segments")
        n_pages = segs[0]["k_pages"].shape[1] - 1
        if min(ids) < 0 or max(ids) > n_pages:
            raise ValueError(f"upload page ids must lie in [0, {n_pages}]")
        idx = runtime.host_array_on(np.asarray(ids, np.int64),
                                    cache["lengths"].device)
        for seg, pay in zip(segs, payloads):
            for key, leaf in seg.items():
                src = pay[key].to(device=leaf.device,
                                  dtype=leaf.dtype).contiguous()
                leaf.view(torch.uint8).index_copy_(1, idx,
                                                   src.view(torch.uint8))
    cache["lengths"][slot] = int(ctx_len)
    return cache
