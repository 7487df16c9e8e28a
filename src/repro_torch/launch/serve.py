"""PICE serving launcher (PyTorch port): build the cloud engine + edge fleet
on the card and run the progressive pipeline on a stream of requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \
      [--train-steps 150] [--kv-backend {dense,paged}] [--device cpu]

As the JAX package's launcher does, each TINY model is first trained on the
synthetic corpus for `--train-steps` steps (default 150; float32 masters
from `--seed`, AdamW, the card's backward kernels on a CUDA device), so
that sketches and expansions mean something and the ROUGE-1 lines score a
trained fleet; the trained masters are then cast to the engines' working
dtypes. `--train-steps 0` serves the random weights untrained. The TINY
edge fleet is the two dense SLMs and the Mamba2 TINY_EDGE_C.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.pice_cloud_edge import TINY_CLOUD, TINY_EDGE_CONFIGS
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.profiler import cost_coefficient, profile_engine
from repro_torch.core.progressive import PICEConfig, PICEPipeline
from repro_torch.core.scheduler import EdgeModelInfo
from repro_torch.data import corpus as corpus_lib
from repro_torch.data.pipeline import PackedDataset
from repro_torch.models import transformer
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.requests import Request
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import init_train_state, train

CAPABILITIES = {"tiny-cloud": 0.9, "tiny-edge-a": 0.7, "tiny-edge-b": 0.55,
                "tiny-edge-c": 0.6, "qwen3-8b": 0.9, "qwen2-1.5b": 0.7,
                "xlstm-1.3b": 0.6, "zamba2-2.7b": 0.6}


def build_engines(train_steps: int = 0, seed: int = 0, names=None,
                  device=None, kv_backend: str = "paged", log_fn=print):
    """The TINY fleet as `kv_backend` engines on `device` (default the
    card), each config with its own prefill_chunk (monolithic for the TINY
    fleet, as in the JAX package's launcher). With `train_steps`, each
    model first trains on the synthetic corpus as the JAX launcher's do
    (`PackedDataset(text, 192, 8, seed)`, AdamW at lr 2e-3 with 20 warmup
    steps, logs at the middle and the end) and serves its trained masters
    cast to the working dtypes. Returns (engines, capabilities)."""
    device = resolve_device(device)
    text = corpus_lib.lm_text(2000, seed)
    pool = [("tiny-cloud", TINY_CLOUD)] + list(TINY_EDGE_CONFIGS.items())
    if names:
        pool = [(n, c) for n, c in pool if n in names]
    engines = {}
    for name, cfg in pool:
        state = init_train_state(cfg, seed, device=device)
        if train_steps:
            ds = PackedDataset(text, 192, 8, seed)
            opt_cfg = opt_lib.AdamWConfig(lr=2e-3, warmup_steps=20,
                                          total_steps=train_steps)
            log_fn(f"-- training {name} for {train_steps} steps")
            state = train(cfg, state, iter(ds), opt_cfg, train_steps,
                          log_every=max(train_steps // 2, 1), log_fn=log_fn)
        params = transformer.serving_params(cfg, state.params)
        engines[name] = InferenceEngine(cfg, params, max_batch=8,
                                        max_len=1024, name=name,
                                        kv_backend=kv_backend, device=device)
    return engines, CAPABILITIES


def build_pipeline(engines, caps, log_fn=print, profile_lengths=(8, 16, 32),
                   cloud_name: str = "tiny-cloud") -> PICEPipeline:
    """Profile every engine, then wrap them in the PICE pipeline with
    `cloud_name` as the cloud LLM and the rest as the edge fleet."""
    cloud = engines[cloud_name]
    lm_cloud = profile_engine(cloud, lengths=profile_lengths, name=cloud_name)
    infos = []
    for name, eng in engines.items():
        if name == cloud_name:
            continue
        lm = profile_engine(eng, lengths=profile_lengths, name=name)
        c = cost_coefficient(lm_cloud, lm)
        log_fn(f"profiled {name}: rate={lm.rate:.1f} tok/s, c={c:.2f}")
        infos.append(EdgeModelInfo(name=name, latency=lm,
                                   capability=caps.get(name, 0.5)))
    edge_engines = {k: v for k, v in engines.items() if k != cloud_name}
    return PICEPipeline(cloud, edge_engines, lm_cloud, infos,
                        cfg=PICEConfig(ensemble_size=2))


def response_line(resp, quality: float) -> str:
    return (f"[{resp.mode:12s}] lat={resp.latency_s:5.2f}s "
            f"cloud={resp.cloud_tokens:4d}t edge={resp.edge_tokens:4d}t "
            f"rouge1-f1={quality:.3f} | {resp.text[:60]!r}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-backend", choices=("dense", "paged"),
                    default="paged",
                    help="KV cache backend (paged = on-demand page pool)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main():
    args = parse_args()

    engines, caps = build_engines(args.train_steps, args.seed,
                                  device=args.device,
                                  kv_backend=args.kv_backend)
    pipe = build_pipeline(engines, caps)
    examples = corpus_lib.corpus(args.requests, seed=args.seed + 7)
    t0 = time.time()
    quality = []
    for ex in examples:
        resp = pipe.handle(Request(query=ex.query, category=ex.category))
        q = metrics_lib.rouge_1(ex.answer, resp.text)[2]
        quality.append(q)
        print(response_line(resp, q))
    dt = time.time() - t0
    print(f"\n{args.requests} requests in {dt:.1f}s "
          f"({60*args.requests/dt:.1f} req/min); "
          f"mean quality={sum(quality)/len(quality):.3f}; stats={pipe.stats}")


if __name__ == "__main__":
    main()
