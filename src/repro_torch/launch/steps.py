"""Step-function builders shared by the trainer and the server (the JAX
package's `launch/steps.py` in PyTorch).

`make_train_step` is one training step on float32 master params: cast them
to the working dtypes inside the graph (`transformer.cast_params`, the JAX
package's `_cast_once`), run the differentiable `forward` (on the card its
norms, attention and scans go through the hand-written kernels forward and
backward), take the loss's gradients on the masters with
`torch.autograd.grad` and apply AdamW in place. Nothing is read back to
the host: the metrics stay device scalars.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import losses as losses_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree as tree_lib


def _prefix_len(cfg: ModelConfig) -> int:
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def loss_fn(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            masked: bool = False) -> Tuple[torch.Tensor, dict]:
    """The training loss of master params on a batch {tokens, targets[,
    mask][, prefix_embeds][, enc_frames]}: `lm_loss` (the JAX package's
    `make_train_step`; a VLM's loss drops its n_prefix patch positions),
    or with `masked` the masked cross entropy plus the aux term (its
    `train(masked=True)`). -> (loss, metrics)."""
    working = transformer.cast_params(cfg, params)
    logits, aux = transformer.forward(
        cfg, working, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"))
    if masked:
        loss, _ = losses_lib.cross_entropy(logits, batch["targets"],
                                           batch["mask"])
        return loss + cfg.router_aux_coef * aux, {"nll": loss}
    return losses_lib.lm_loss(cfg, logits, batch["targets"], aux,
                              prefix_len=_prefix_len(cfg))


def grad_of(fn: Callable, params):
    """fn(params) -> (loss, aux): -> (loss, aux, grads), detached; grads a
    tree like params, None where the loss does not reach a leaf (the
    length head). The leaves record autograd only inside the call."""
    flat = tree_lib.leaves(params)
    with torch.enable_grad():
        for p in flat:
            p.requires_grad_(True)
        try:
            loss, aux = fn(params)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
    return (loss.detach(), tree_lib.tree_map(torch.Tensor.detach, aux),
            tree_lib.unflatten(params, list(grads)))


def value_and_grad(cfg: ModelConfig, params: dict,
                   batch: Dict[str, torch.Tensor], masked: bool = False):
    """(loss, metrics, grads) of `loss_fn` (`grad_of`)."""
    return grad_of(lambda p: loss_fn(cfg, p, batch, masked), params)


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig,
                    masked: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics); params and
    the moments are updated in place.

    batch: {tokens, targets[, mask][, prefix_embeds][, enc_frames]} on the
    params' device."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch, masked)
        params, opt_state, opt_metrics = opt_lib.adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, cache, prompt_lengths=None,
                     enc_frames=None, prefix_embeds=None):
        return transformer.prefill(cfg, params, tokens, cache,
                                   prompt_lengths=prompt_lengths,
                                   prefix_embeds=prefix_embeds,
                                   enc_frames=enc_frames)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, cache):
        return transformer.decode_step(cfg, params, tokens, cache)
    return decode_step
