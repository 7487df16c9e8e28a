"""Run one cell of BENCHMARK.json on the card this process finds.

  python3 pice_bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Builds the cell's configuration (`configs/<config>.json`) from `--seed`,
warms it up, offers the cell's mix (`traffic/<mix>.json`) to
`PICEPipeline.handle_async` for `--seconds`, and prints one JSON line: the
cell's end-to-end metrics (`--trace 0`) or its per-layer metrics with the
device's busy time and a breakdown (`--trace 1`), whether the served
tokens agree with the plain reference (`correct`), and last the numbers
compared, each with its limit. The same numbers end standard error.

Exits non-zero and prints no result when no CUDA card (or fewer than the
cell asks for) is visible, when the program (`src/repro_torch`) is not in
the checkout, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_files(name: str):
    """(cell, configuration, mix) of the cell called `name`."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def report_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell, config, traffic = cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 4
    from pice_bench import harness
    run = harness.Run(cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    out = run.execute()
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"notes {json.dumps(run.notes)}", file=sys.stderr)
    print(f"readings {json.dumps(run.readings)}", file=sys.stderr)
    report_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
