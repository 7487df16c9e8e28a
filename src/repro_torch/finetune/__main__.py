"""§IV-D fine-tuning entry point: SFT -> preference labeling -> reward model ->
RLAIF, producing a cloud model that emits concise, semantically complete
sketches (the JAX package's `examples/rlaif_sketch_finetune.py`, with its
arguments and defaults; the card unless `--device` names another).

Run:  PYTHONPATH=src python -m repro_torch.finetune [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.pice_cloud_edge import TINY_CLOUD
from repro_torch.data import corpus as corpus_lib
from repro_torch.data import tokenizer as tok
from repro_torch.finetune.preference import label_pair
from repro_torch.finetune.reward_model import train_reward_model
from repro_torch.finetune.rlaif import RLAIFConfig, run_rlaif
from repro_torch.finetune.sft import run_sft
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.engine import InferenceEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sft-steps", type=int, default=200)
    ap.add_argument("--rm-steps", type=int, default=80)
    ap.add_argument("--rl-steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, log_fn=print):
    """Runs the pipeline; returns (policy masters, RLAIF history)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = TINY_CLOUD.with_(dtype="float32")

    log_fn("== step 1: supervised fine-tuning (document -> sketch)")
    state = run_sft(cfg, n_steps=args.sft_steps, device=device,
                    log_fn=log_fn)

    log_fn("== step 2: preference labeling + reward model")
    sft_engine = InferenceEngine(
        cfg, transformer.serving_params(cfg, state.params), max_batch=4,
        max_len=768, kv_backend="dense", device=device)

    def expand(x: str, r: str) -> str:
        (out, _), = sft_engine.generate(
            [tok.encode(f"Q: {x[:80]}\nS: {r}\nE:")], max_new=96)
        return tok.decode(out)

    triples = []
    for ex in corpus_lib.corpus(32, seed=9):
        # candidate sketches: the gold one and a verbose prefix of the answer
        triples.append(label_pair(ex.answer[:160], ex.answer, ex.sketch,
                                  ex.answer[: 2 * len(ex.sketch)], expand))
    wins = sum(t.r_w != t.x for t in triples)
    log_fn(f"labeled {len(triples)} pairs "
           f"(concise sketch preferred in {wins})")
    rm_params = train_reward_model(cfg, triples, n_steps=args.rm_steps,
                                   device=device, log_fn=log_fn)

    log_fn("== step 3: RLAIF (REINFORCE + KL to SFT policy)")
    policy, hist = run_rlaif(cfg, state.params, state.params, cfg, rm_params,
                             RLAIFConfig(n_steps=args.rl_steps, batch=2),
                             log_fn=log_fn)
    log_fn(f"reward: {hist[0]['mean_reward']:.4f} -> "
           f"{hist[-1]['mean_reward']:.4f}, final KL={hist[-1]['kl']:.4f}")
    return policy, hist


if __name__ == "__main__":
    main()
