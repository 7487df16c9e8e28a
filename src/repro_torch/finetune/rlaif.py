"""RL fine-tuning from AI feedback (paper §IV-D step 3).

Policy pi_theta initialized from the SFT model, optimized for

    J(theta) = E_{r ~ pi_theta(.|x)} [ (1 - gamma) R_phi(r|x)
                                       - gamma D_KL(pi_theta || pi_SFT) ]

via REINFORCE with a moving-average baseline; the KL term is estimated
token-wise on sampled sketches (log pi_theta - log pi_SFT).

The JAX package's `finetune/rlaif.py` in PyTorch, with two differences its
immutable arrays make unnecessary there. AdamW updates the port's params in
place, so `run_rlaif` clones the policy at entry: callers pass the SFT
params as both the policy and the reference, and the reference must not
move with the policy. The engine holds working params cast once, so each
step hands it `transformer.serving_params` of the policy; it is not warmed
(a warmed engine raises when a parameter moves, and the JAX package's loop
does not warm either). Sampled sketches come from the engine's generator:
the same seed gives the same run, not the JAX package's draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import corpus as corpus_lib
from repro_torch.data import tokenizer as tok
from repro_torch.finetune.reward_model import encode_pair, reward_fwd
from repro_torch.kernels import runtime
from repro_torch.launch.steps import grad_of
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree as tree_lib


@dataclasses.dataclass
class RLAIFConfig:
    gamma: float = 0.2             # KL weight
    lr: float = 3e-4
    n_steps: int = 60
    batch: int = 4
    max_sketch_tokens: int = 64
    seq_len: int = 160
    seed: int = 0


def _pow2_bucket(n: int, cap: int) -> int:
    """Pow2 bucket clamped to cap: O(log cap) shapes in all, instead of one
    per distinct (prompt, sketch) length pair."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _seq_logprob(cfg: ModelConfig, params, full_ids: torch.Tensor,
                 prompt_len: int, gen_len: int):
    """Differentiable sum log pi(gen | prompt) over a right-padded buffer.

    `full_ids` (L,) is prompt + gen zero-padded to a bucketed length;
    causal attention makes logits at positions < prompt_len + gen_len
    independent of the padding, so bucketing changes shapes, not values.
    Returns (sum_lp, masked per-token lp, mask), each over L - 1
    positions."""
    working = transformer.cast_params(cfg, params)
    logits, _ = transformer.forward(cfg, working, full_ids[None, :-1])
    logp = torch.log_softmax(logits[0].float(), dim=-1)
    lp = logp.gather(-1, full_ids[1:, None].long())[:, 0]
    pos = torch.arange(lp.shape[0], device=lp.device)
    mask = ((pos >= prompt_len - 1)
            & (pos < prompt_len - 1 + gen_len)).float()
    gen_lp = lp * mask
    return gen_lp.sum(), gen_lp, mask


def rlaif_loss(cfg: ModelConfig, gamma: float, params, full_ids, prompt_len,
               gen_len, advantage: float, ref_lp: torch.Tensor):
    """-advantage * the mean generated logprob + gamma * the KL to the SFT
    policy over the generated positions -> (loss, (kl, sum_lp))."""
    sum_lp, gen_lp, mask = _seq_logprob(cfg, params, full_ids, prompt_len,
                                        gen_len)
    n_gen = mask.sum().clamp(min=1.0)
    # E[log pi - log pi_sft] over the generated positions only
    kl = ((gen_lp - ref_lp) * mask).sum() / n_gen
    pg = -advantage * sum_lp / n_gen
    return pg + gamma * kl, (kl, sum_lp)


def _add(a, b):
    """Gradient sum; None (a leaf the loss does not reach) stays None."""
    return None if a is None else a + b


def run_rlaif(policy_cfg: ModelConfig, policy_params, sft_params,
              rm_cfg: ModelConfig, rm_params,
              cfg: RLAIFConfig = RLAIFConfig(), log_fn=print):
    """REINFORCE on float32 master params; runs on the params' device.
    Neither `policy_params` nor `sft_params` is written (they may be one
    tree). Returns (the fine-tuned policy's masters, the history: one
    {"step", "mean_reward", "kl"} a step)."""
    policy_params = tree_lib.tree_map(lambda t: t.detach().clone(),
                                      policy_params)
    device = tree_lib.leaves(policy_params)[0].device
    rng = np.random.default_rng(cfg.seed)
    examples = corpus_lib.corpus(512, cfg.seed)
    opt_cfg = opt_lib.AdamWConfig(lr=cfg.lr, warmup_steps=5,
                                  total_steps=cfg.n_steps, grad_clip=1.0)
    opt_state = opt_lib.init_opt_state(policy_params)
    baseline = 0.0

    # one engine, params swapped per step (sampling is non-differentiable)
    engine = InferenceEngine(policy_cfg,
                             transformer.serving_params(policy_cfg,
                                                        policy_params),
                             max_batch=cfg.batch, max_len=512,
                             kv_backend="dense", device=device,
                             seed=cfg.seed,
                             sampler=SamplerConfig(temperature=0.9, top_k=40))
    history = []
    for step in range(cfg.n_steps):
        engine.params = transformer.serving_params(policy_cfg,
                                                   policy_params)
        idx = rng.integers(0, len(examples), cfg.batch)
        prompts, gens, rewards_d = [], [], []
        with torch.no_grad():
            for i in idx:
                ex = examples[i]
                prompt = tok.encode(f"A: {ex.answer[:200]}\nS:")
                (out, _), = engine.generate([prompt],
                                            max_new=cfg.max_sketch_tokens)
                sketch = tok.decode(out)
                r_in = encode_pair(ex.answer[:200], sketch, cfg.seq_len)
                rewards_d.append(reward_fwd(
                    rm_cfg, rm_params,
                    runtime.host_array_on(r_in[None], device).long())[0])
                prompts.append(np.asarray(prompt, np.int32))
                gens.append(np.asarray(out if out else [tok.EOS], np.int32))
        # one batched reward read a step
        rewards = torch.stack(rewards_d).tolist()
        mean_r = float(np.mean(rewards))
        baseline = 0.9 * baseline + 0.1 * mean_r if step else mean_r
        kls_d = []
        grads_acc = None
        for p_ids, g_ids, r in zip(prompts, gens, rewards):
            n_p, n_g = len(p_ids), len(g_ids)
            L = _pow2_bucket(n_p + n_g, 512)
            n_g = min(n_g, max(L - n_p, 0))     # tail-truncate at the cap
            full = np.zeros((L,), np.int32)
            full[:n_p] = p_ids
            full[n_p:n_p + n_g] = g_ids[:n_g]
            full_d = runtime.host_array_on(full, device).long()
            with torch.no_grad():
                ref_lp = _seq_logprob(policy_cfg, sft_params, full_d, n_p,
                                      n_g)[1]
            adv = (1.0 - cfg.gamma) * (r - baseline)
            _, (kl, _), grads = grad_of(
                lambda p: rlaif_loss(policy_cfg, cfg.gamma, p, full_d, n_p,
                                     n_g, adv, ref_lp), policy_params)
            kls_d.append(kl)
            grads_acc = grads if grads_acc is None else tree_lib.tree_map(
                _add, grads_acc, grads)
        grads_acc = tree_lib.tree_map(
            lambda g: None if g is None else g / cfg.batch, grads_acc)
        policy_params, opt_state, _ = opt_lib.adamw_update(
            opt_cfg, policy_params, grads_acc, opt_state)
        # one batched KL read a step
        kls = torch.stack(kls_d).tolist()
        history.append({"step": step, "mean_reward": mean_r,
                        "kl": float(np.mean(kls))})
        if (step + 1) % 10 == 0 or step == cfg.n_steps - 1:
            log_fn(f"RLAIF step {step+1}: reward={mean_r:.4f} "
                   f"kl={np.mean(kls):.4f}")
    return policy_params, history
