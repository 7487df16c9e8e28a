"""PICE serving launcher (PyTorch port): build the cloud engine + edge fleet
on the card and run the progressive pipeline on a stream of requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --train-steps 0 \
      [--kv-backend {dense,paged}] [--device cpu]

The weights are random from `--seed` (no checkpoint is in the repository),
so the text is gibberish while the engines do the full work. Training the
tiny fleet first (`--train-steps > 0`) waits for the training slice. The
TINY edge fleet is the two dense SLMs and the Mamba2 TINY_EDGE_C.
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
from repro_torch.models import transformer
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.requests import Request

CAPABILITIES = {"tiny-cloud": 0.9, "tiny-edge-a": 0.7, "tiny-edge-b": 0.55,
                "tiny-edge-c": 0.6, "qwen3-8b": 0.9, "qwen2-1.5b": 0.7,
                "xlstm-1.3b": 0.6, "zamba2-2.7b": 0.6}


def build_engines(train_steps: int = 0, seed: int = 0, names=None,
                  device=None, kv_backend: str = "paged"):
    """The TINY fleet as `kv_backend` engines on `device` (default the
    card), each config with its own prefill_chunk (monolithic for the TINY
    fleet, as in the JAX package's launcher). Returns (engines,
    capabilities)."""
    if train_steps:
        raise NotImplementedError(
            "--train-steps > 0 waits for the training slice; serve with "
            "--train-steps 0")
    device = resolve_device(device)
    pool = [("tiny-cloud", TINY_CLOUD)] + list(TINY_EDGE_CONFIGS.items())
    if names:
        pool = [(n, c) for n, c in pool if n in names]
    engines = {}
    for name, cfg in pool:
        params = transformer.init_params(cfg, seed, device=device)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-backend", choices=("dense", "paged"),
                    default="paged",
                    help="KV cache backend (paged = on-demand page pool)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

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
