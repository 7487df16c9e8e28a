"""Reward model (paper §IV-D step 2): scalar sketch-preference scorer trained
with the Bradley-Terry pairwise loss

    L_R(phi) = -E_{(x, r_w, r_l)} [ log sigmoid( R(x, r_w) - R(x, r_l) ) ].

R is a small transformer with a mean-pooled scalar head over 'x | r'. The
JAX package's `finetune/reward_model.py` in PyTorch: float32 master params
(the head among them, kept in float32 in the working params too), each
step eager, the batches drawn from `np.random.default_rng(seed)` as the
JAX package draws them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import tokenizer as tok
from repro_torch.finetune.preference import PreferenceTriple
from repro_torch.kernels import runtime
from repro_torch.launch.steps import grad_of
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree as tree_lib


def init_reward_model(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Float32 master params from `seed` (`init_params(master=True)`) on
    `device` (default the card) with a (d_model, 1) reward head drawn from
    seed + 1."""
    device = runtime.resolve_device(device)
    params = transformer.init_params(cfg, seed, device=device, master=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    params["reward_head"] = dense_init(gen, (cfg.d_model, 1), device=device)
    return params


def reward_fwd(cfg: ModelConfig, params: dict, tokens: torch.Tensor
               ) -> torch.Tensor:
    """tokens: (B, S) -> scalar reward (B,): the final-normed hidden states
    mean-pooled over the non-EOS positions, times the head, in float32.
    `params` are masters or working params (cast here, differentiably)."""
    working = transformer.cast_params(cfg, params)
    _, _, hidden = transformer.forward(cfg, working, tokens,
                                       return_hidden=True)
    mask = (tokens != tok.EOS).float()[..., None]
    pooled = (hidden.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp(
        min=1.0)
    return (pooled @ working["reward_head"].float())[:, 0]


def encode_pair(x: str, r: str, seq_len: int) -> np.ndarray:
    ids = tok.encode(x)[: seq_len // 2] + [ord("|")] + tok.encode(r)
    ids = ids[:seq_len]
    out = np.zeros((seq_len,), np.int32)
    out[: len(ids)] = ids
    return out


def bt_loss(cfg: ModelConfig, params: dict, tok_w: torch.Tensor,
            tok_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the Bradley-Terry loss, the share of pairs ranked right)."""
    rw = reward_fwd(cfg, params, tok_w)
    rl = reward_fwd(cfg, params, tok_l)
    return -F.logsigmoid(rw - rl).mean(), (rw > rl).float().mean()


def train_reward_model(cfg: ModelConfig, triples: Sequence[PreferenceTriple],
                       n_steps: int = 150, batch: int = 8, seq_len: int = 160,
                       lr: float = 1e-3, seed: int = 0, log_fn=print,
                       device=None) -> dict:
    """`n_steps` of AdamW on `bt_loss` from `init_reward_model(cfg, seed)`;
    one host read a log line. -> the trained float32 masters."""
    params = init_reward_model(cfg, seed, device)
    device = tree_lib.leaves(params)[0].device
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=10, total_steps=n_steps)
    opt_state = opt_lib.init_opt_state(params)
    rng = np.random.default_rng(seed)

    tw = np.stack([encode_pair(t.x, t.r_w, seq_len) for t in triples])
    tl = np.stack([encode_pair(t.x, t.r_l, seq_len) for t in triples])
    for i in range(n_steps):
        idx = rng.integers(0, len(triples), batch)
        bw = runtime.host_array_on(tw[idx], device).long()
        bl = runtime.host_array_on(tl[idx], device).long()
        loss, acc, grads = grad_of(lambda p: bt_loss(cfg, p, bw, bl),
                                   params)
        params, opt_state, _ = opt_lib.adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        if (i + 1) % 25 == 0 or i == n_steps - 1:
            # repro-analysis: disable=RA103 reason=one batched read of loss and accuracy a log interval
            loss_h, acc_h = torch.stack([loss, acc]).tolist()
            log_fn(f"RM step {i+1}: loss={loss_h:.4f} "
                   f"pair_acc={acc_h:.3f}")
    return params
