"""Profile the warmed engines of a configuration once, for the frozen
latency models `(t0, rate)` its file keeps.

  python3 pice_bench/profile_latency.py --config pice-dense [--seed 1]

Builds the fleet as a run does (weights from the seed, warm-up at the
progressive mix's shapes) and fits f(l) = t0 + l / rate to one request's
generation time at 32, 96 and 160 new tokens after a 512-token query in
the cloud's sketch prompt, with the program's own
`core/profiler.profile_engine`. Prints one JSON line per engine.
"""
import argparse
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from pice_bench import harness
    from pice_bench.traffic import generator
    from repro_torch.core.profiler import profile_engine
    from repro_torch.data import tokenizer as tok
    config = harness.load_json(HERE / "configs" / f"{args.config}.json")
    traffic = generator.load("progressive")
    fleet = harness.Fleet(config, traffic, args.seed, "cuda")
    query = generator.text(random.Random(args.seed), 512)
    prompt = tok.encode(f"Q: {query}\nS:")
    for role, eng in fleet.engines.items():
        t = time.perf_counter()
        lm = profile_engine(eng, lengths=(32, 96, 160), prompt=prompt)
        print(json.dumps({"config": args.config, "role": role,
                          "name": eng.name, "t0": lm.t0, "rate": lm.rate,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
