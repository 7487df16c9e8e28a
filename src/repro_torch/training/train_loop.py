"""Generic training loop over train steps (the JAX package's
`training/train_loop.py` in PyTorch).

The loop keeps the JAX package's one host read per `log_every` steps: the
metrics stay device scalars between logs and are read in one transfer at a
log step (no `.item()`, `.cpu()` or `.tolist()` in between), so the card
runs ahead of the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass
class TrainState:
    params: dict                 # float32 masters
    opt_state: opt_lib.OptState
    step: int = 0


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> TrainState:
    """Float32 master params from `seed` (`init_params(master=True)`) on
    `device` (default the card) and zero moments."""
    params = transformer.init_params(cfg, seed, device=device, master=True)
    return TrainState(params=params, opt_state=opt_lib.init_opt_state(params))


def _on(device, arr) -> torch.Tensor:
    return runtime.host_array_on(np.asarray(arr), device)


def train(cfg: ModelConfig, state: TrainState, batches: Iterator,
          opt_cfg: opt_lib.AdamWConfig, n_steps: int, log_every: int = 20,
          log_fn: Callable = print, masked: bool = False) -> TrainState:
    """batches yields (tokens, targets) or, with `masked`, (tokens, targets,
    mask) numpy arrays; each is moved to the params' device once."""
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, masked=masked)
    device = state.opt_state.step.device
    t0 = time.time()
    for i in range(n_steps):
        b = next(batches)
        batch = {"tokens": _on(device, b[0]).long(),
                 "targets": _on(device, b[1]).long()}
        if masked:
            batch["mask"] = _on(device, b[2])
        state.params, state.opt_state, metrics = step_fn(
            state.params, state.opt_state, batch)
        state.step += 1
        if (i + 1) % log_every == 0 or i == n_steps - 1:
            # one device->host read per log_every steps
            names = list(metrics)
            vals = torch.stack([metrics[k].float().reshape(())
                                for k in names]).tolist()
            m = dict(zip(names, vals))
            log_fn(f"step {state.step:5d} loss={m['loss']:.4f} "
                   f"nll={m.get('nll', 0):.4f} "
                   f"({(time.time()-t0)/(i+1):.3f}s/step)")
    return state
