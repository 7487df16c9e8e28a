"""AdamW + gradient clipping + LR schedules, implemented from scratch.

The JAX package's `training/optimizer.py` in PyTorch: the same arithmetic
step for step in float32 on the device (no host read), the parameters and
moments updated in place under `torch.no_grad()`. `torch.optim.AdamW` is a
different function (its weight decay multiplies the parameter before the
step, and it has no global clip).

Weight decay follows the JAX package's parameter layout, not the port's.
The JAX package decays a leaf of ndim >= 2 and stacks every segment's
layers (and an encoder's) on a leading axis, so every per-layer leaf
there, norm scales, biases and Mamba2's A_log, D and dt_bias included, is
at least 2-D and decays; of the unstacked leaves, the embeddings, the
learned positions, the length and reward heads and a hybrid's shared
attention projections and biases ((H, hd) there) decay, while the final
norms and the shared block's norm scales do not. The
port keeps per-layer 1-D leaves, so it decides by the rank a leaf has in
the JAX package's layout (`reference_ndim`). A gradient of None (a leaf
no loss reached, e.g. the length head) counts as zeros: the moments still
decay and weight decay still moves the leaf, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.training import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"     # cosine | linear | constant


class OptState(NamedTuple):
    step: torch.Tensor           # () int32, on the params' device
    mu: dict
    nu: dict


def init_opt_state(params) -> OptState:
    flat = tree_lib.leaves(params)
    device = flat[0].device if flat else None
    zeros = tree_lib.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros,
                    nu=tree_lib.tree_map(torch.clone, zeros))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:  # cosine
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32; None leaves
    count as zeros."""
    flat = [g for g in tree_lib.leaves(tree) if g is not None]
    if not flat:
        return torch.zeros(())
    return torch.sqrt(torch.stack([g.float().square().sum()
                                   for g in flat]).sum())


# leaves the port stores with one axis fewer than the JAX package does:
# q/k/v/o projections (d, H, hd) / (H, hd, d) and their biases (H, hd)
_FLATTENED = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def reference_ndim(path: Tuple, leaf: torch.Tensor) -> int:
    """The rank of the leaf at `path` in the JAX package's params: a
    segment's leaves and an encoder's blocks carry the stacked layer axis,
    and the attention projections and biases an unflattened head axis."""
    nd = leaf.dim()
    if path and (path[0] == "segments" or path[:2] == ("encoder", "blocks")):
        nd += 1
    if path and path[-1] in _FLATTENED:
        nd += 1
    return nd


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[dict, OptState, dict]:
    """One AdamW step. Updates params and the moments in place and returns
    (params, the new OptState, {"grad_norm", "lr"} as device scalars)."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    flat = tree_lib.leaves_with_path(params)
    flat_g = tree_lib.leaves(grads)
    flat_mu = tree_lib.leaves(state.mu)
    flat_nu = tree_lib.leaves(state.nu)
    if not len(flat) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("params, grads and moments differ in structure")
    for (path, p), g, mu, nu in zip(flat, flat_g, flat_mu, flat_nu):
        g = (torch.zeros_like(mu) if g is None else g.float()) * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if cfg.weight_decay and reference_ndim(path, p) >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, mu=state.mu, nu=state.nu), metrics
