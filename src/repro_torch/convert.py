"""The JAX package's params pytree -> the port's params.

The JAX package stacks each segment's layer params on a leading layer axis
(`repro/models/transformer.py` init_params / _run_segment) and keeps every
leaf in float32. The port keeps one dict per layer, 2-D projection weights
and flat biases (see `models/attention.py`), and each leaf in its working
dtype: matmul weights, embeddings and biases in `cfg.dtype`, norm scales and
the length head in float32. A Mamba2 layer keeps A_log, D, dt_bias and its
norm scale in float32 (the JAX package casts them to float32 at use) and
w_in, w_out, conv_w and conv_b in `cfg.dtype`. An xLSTM layer keeps the
gate biases (the mLSTM's b_i and b_f, the sLSTM's b_gates), the sLSTM's
recurrent weights r_gates and its norm scales in float32, which the JAX
package computes with (a bf16 r_gates would round the recurrence at every
token), and its projections in `cfg.dtype`. A MoE layer's "moe" leaves
(router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D)) keep the JAX
package's shapes, unstacked from the layer axis, in `cfg.dtype`. A
hybrid's shared block
(`ref["shared"]`, unstacked) converts as one layer, and its SHARED_ATTN
segments, empty in the pytree, become empty lists. An encoder-decoder's
encoder converts its stacked `blocks` into one dict per layer beside its
`pos` and `final_norm`; `dec_pos`, the decoder's `xattn` and `norm_x`,
LayerNorm biases (kept in float32, as the scales) and the ungated MLP's
b_up / b_down (in `cfg.dtype`) carry across as the other leaves do. A
reward model's top-level `reward_head` stays in float32, as the length
head does. Give this module the
pytree as numpy arrays (`jax.tree.map(np.asarray, params)`), so the port
itself never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.models.config import SHARED_ATTN, ModelConfig
from repro_torch.models.layers import FLOAT32_LEAVES, compute_dtype
from repro_torch.models.transformer import check_supported, segments_of


def _leaf(name: str, a: np.ndarray, dtype, device) -> torch.Tensor:
    a = np.array(a, np.float32)          # a writable copy
    if name in ("wq", "wk", "wv"):            # (d, H, hd) -> (d, H*hd)
        a = a.reshape(a.shape[0], -1)
    elif name == "wo":                        # (H, hd, d) -> (H*hd, d)
        a = a.reshape(-1, a.shape[-1])
    elif name in ("bq", "bk", "bv"):          # (H, hd) -> (H*hd,)
        a = a.reshape(-1)
    keep_f32 = name in FLOAT32_LEAVES
    return torch.from_numpy(a).to(device=device,
                                  dtype=torch.float32 if keep_f32 else dtype)


def _convert(tree, dtype, device, name: str = ""):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, k) for k, v in tree.items()}
    return _leaf(name, tree, dtype, device)


def params_from_reference(cfg: ModelConfig, ref: Dict[str, Any],
                          device=None, master: bool = False) -> dict:
    """ref: the JAX params pytree with numpy leaves -> the port's params on
    `device` (default the card; see `kernels.runtime.resolve_device`): the
    working params, or with `master` every leaf in float32 (the training
    masters, `transformer.init_params(master=True)`; also the layout the
    JAX package's gradients convert into)."""
    check_supported(cfg)
    device = runtime.resolve_device(device)
    dtype = torch.float32 if master else compute_dtype(cfg)
    segments = []
    for (kind, count), stacked in zip(segments_of(cfg), ref["segments"]):
        segments.append([] if kind == SHARED_ATTN else
                        _unstack(stacked, count, dtype, device))
    out = {"embed": _convert(ref["embed"], dtype, device),
           "segments": segments,
           "final_norm": _convert(ref["final_norm"], dtype, device)}
    if "shared" in ref:
        out["shared"] = _convert(ref["shared"], dtype, device)
    if "encoder" in ref:
        enc = ref["encoder"]
        out["encoder"] = {
            "pos": _convert(enc["pos"], dtype, device),
            "blocks": _unstack(enc["blocks"], cfg.encoder.n_layers, dtype,
                               device),
            "final_norm": _convert(enc["final_norm"], dtype, device)}
    if "dec_pos" in ref:
        out["dec_pos"] = _convert(ref["dec_pos"], dtype, device)
    for head in ("length_head", "reward_head"):
        if head in ref:
            out[head] = torch.from_numpy(
                np.array(ref[head], np.float32)).to(device)
    return out


def _unstack(stacked, count: int, dtype, device) -> list:
    """A stacked segment (leading layer axis) -> one converted dict a
    layer."""
    return [_convert(_take(stacked, i), dtype, device) for i in range(count)]


def _take(tree, i: int):
    """Layer i of a stacked (leading layer axis) subtree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
