"""Training launcher (PyTorch port).

Trains a reduced variant of --arch on the synthetic corpus on one device
(default the card; `--device cpu` runs the plain PyTorch versions of the
kernels on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 50
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.data import corpus as corpus_lib
from repro_torch.data.pipeline import PackedDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import save
from repro_torch.training.train_loop import init_train_state, train


# families whose forward takes stub embeddings beside the tokens
STUB_INPUTS = {"encdec": "enc_frames (stub frame embeddings)",
               "vlm": "prefix_embeds (stub patch embeddings)"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch).reduced(remat=False)
    if cfg.family in STUB_INPUTS:
        raise ValueError(
            f"{args.arch} needs {STUB_INPUTS[cfg.family]} in every batch, "
            "which the synthetic text pipeline does not make (the JAX "
            "launcher cannot train it either); train it through "
            "launch/steps.make_train_step with those inputs in the batch")
    device = resolve_device(args.device)
    print(f"training reduced {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family} on {device}")
    text = corpus_lib.lm_text(3000, args.seed)
    ds = PackedDataset(text, args.seq_len, args.batch, args.seed)
    state = init_train_state(cfg, args.seed, device=device)
    opt_cfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps)
    state = train(cfg, state, iter(ds), opt_cfg, args.steps)
    if args.ckpt:
        path = save(args.ckpt, state.step, state.params)
        print(f"saved checkpoint to {path}")


if __name__ == "__main__":
    main()
