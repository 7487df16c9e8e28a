"""Mixture-of-Experts FFN (PyTorch) with capacity-based dispatch
(drop-on-overflow): the JAX package's `models/moe.py`.

  1. router top-k -> (expert_id, weight) per assignment, T*k assignments
  2. position-in-expert in flat (token-major, then k) order: a cumsum over
     a one-hot of the assignments' experts, or a stable argsort over expert
     ids (cfg.moe_sort_dispatch); both give the same positions
  3. an (E, C, D) buffer of the kept assignments' tokens (overflow drops)
  4. per-expert SwiGLU: (E, C, D) x (E, D, F) batched products
  5. gather + weighted combine back to (T, D)

The router load-balance auxiliary loss follows Switch / Mixtral:
  aux = E * sum_e( frac_tokens_e * mean_router_prob_e ).

Every shape is static given the call's token count T (the capacity C is a
host integer of T), and no step reads back to the host or adds with
atomics, so a decode step stays capturable in a CUDA graph and two runs of
one call are bitwise equal:
- the buffer is a gather from a per-slot source token (a zero row for an
  empty slot), which is the JAX package's scatter into (E + 1, C, D) with a
  trash row;
- the combine is a fixed-order sum over each token's k gathered rows, which
  is the JAX package's scatter-add over `token_idx = repeat(arange(T), k)`;
- ties in the top-k go to the lower expert index, as `jax.lax.top_k` breaks
  them (a stable descending sort; `torch.topk` promises no order).

The capacity counts every token of the call, padding and inactive decode
rows included, as the JAX package counts them, so which tokens drop can
depend on the other rows of a call (ROADMAP §3). The expert products stay
`torch.bmm` over all E experts, as the JAX package's einsums are plain XLA
products outside any Pallas kernel. The JAX package's expert-parallel
sharding constraint (`_ep_constraint`, `mesh`) has no meaning on one card
and is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype,
             device=None) -> dict:
    """router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D), the JAX
    package's shapes and init law, each drawn in float32 one at a time."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, e), dtype=dtype, device=device),
        "w_gate": dense_init(gen, (e, d, f), in_axis=1, dtype=dtype,
                             device=device),
        "w_up": dense_init(gen, (e, d, f), in_axis=1, dtype=dtype,
                           device=device),
        "w_down": dense_init(gen, (e, f, d), in_axis=1, dtype=dtype,
                             device=device),
    }


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    per = n_tokens * cfg.experts_per_token / cfg.n_experts
    cap = int(math.ceil(per * cfg.capacity_factor))
    return max(cap, cfg.experts_per_token, 4)


def route(cfg: ModelConfig, params: dict, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (T, D) -> (top_w (T, k) f32 renormalised over the k, top_e (T, k)
    int64, aux f32 scalar). Router logits are computed in x's dtype and
    taken to float32, as in the JAX package."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = (xf @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # the k largest, ties to the lower index (jax.lax.top_k's order)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # load-balance aux loss; a one-hot by comparison (F.one_hot checks its
    # range on the host)
    experts = torch.arange(E, device=xf.device)
    frac = (top_e[..., None] == experts).float().mean(dim=0).sum(dim=0) / K
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return top_w, top_e, aux


def positions_in_expert(cfg: ModelConfig, flat_e: torch.Tensor
                        ) -> torch.Tensor:
    """Each assignment's rank among the earlier assignments (in flat order)
    to the same expert: (A,) int64 expert ids -> (A,) int64 ranks."""
    E = cfg.n_experts
    A = flat_e.shape[0]
    dev = flat_e.device
    if cfg.moe_sort_dispatch:
        order = torch.sort(flat_e, stable=True).indices
        sorted_e = flat_e[order]
        run_start = torch.searchsorted(sorted_e,
                                       torch.arange(E, device=dev))
        pos_sorted = torch.arange(A, device=dev) - run_start[sorted_e]
        return torch.empty_like(flat_e).index_put_((order,), pos_sorted)
    # the JAX package's exclusive cumsum over a (A, E) one-hot, taken as an
    # inclusive scan along the assignments of an (E, A) one-hot (a scan
    # over the contiguous dimension), read at each assignment's expert
    onehot = (torch.arange(E, device=dev)[:, None] == flat_e).int()
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return ranks.gather(0, flat_e[None]).long()[0] - 1


def dispatch(cfg: ModelConfig, top_e: torch.Tensor, C: int
             ) -> Dict[str, torch.Tensor]:
    """The dispatch plan of T tokens' (T, k) expert choices at capacity C:
    keep (A,) bool, an assignment's flat buffer slot e * C + pos (A,)
    int64 (clamped to 0 where dropped), and each buffer slot's source token
    (E * C,) int64, T for an empty slot."""
    T, K = top_e.shape
    E = cfg.n_experts
    flat_e = top_e.reshape(T * K)
    flat_pos = positions_in_expert(cfg, flat_e)
    keep = flat_pos < C
    slot = torch.where(keep, flat_e * C + flat_pos,
                       torch.zeros_like(flat_e))
    token_idx = torch.div(torch.arange(T * K, device=top_e.device), K,
                          rounding_mode="floor")
    # dropped assignments go to a trash slot E * C, cut off below; kept
    # ones own distinct slots
    source = torch.full((E * C + 1,), T, dtype=torch.int64,
                        device=top_e.device)
    source.index_put_((torch.where(keep, slot, E * C),), token_idx)
    return {"keep": keep, "slot": slot, "source": source[:E * C]}


def expert_inputs(cfg: ModelConfig, xf: torch.Tensor,
                  plan: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (E, C, D) buffer: slot s holds token source[s], zeros where
    empty."""
    D = xf.shape[1]
    xpad = torch.cat([xf, xf.new_zeros(1, D)])
    return xpad[plan["source"]].view(cfg.n_experts, -1, D)


def experts_fwd(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU over the (E, C, D) buffer -> (E, C, D)."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def combine(y: torch.Tensor, plan: Dict[str, torch.Tensor],
            top_w: torch.Tensor) -> torch.Tensor:
    """Each token's kept expert outputs, weighted and summed over its k
    rows in a fixed order: (E, C, D), (T, k) -> (T, D) in y's dtype."""
    T, K = top_w.shape
    D = y.shape[-1]
    y = y.reshape(-1, D)
    gathered = torch.where(plan["keep"][:, None], y[plan["slot"]],
                           y.new_zeros(()))
    w = top_w.reshape(T * K).to(y.dtype)
    return (gathered * w[:, None]).view(T, K, D).sum(dim=1)


def moe_fwd(cfg: ModelConfig, params: dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss f32 scalar)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    top_w, top_e, aux = route(cfg, params, xf)
    plan = dispatch(cfg, top_e, moe_capacity(B * S, cfg))
    y = experts_fwd(params, expert_inputs(cfg, xf, plan))
    return combine(y, plan, top_w).view(B, S, D), aux
