"""Read a cell's compared numbers on many seeds in one process, with the
control beside them: the readings its limits are set from.

  python3 pice_bench/calibrate.py --workload <cell> --seconds 15 \
      --seeds 11,12,13

For each seed a whole run (set-up, ramp, window, reference) with the
control also read: the plain reference computed with float8 operands, at
each position of the same prompts and served tokens. Prints one JSON line
a seed: the program's verdict (`correct`) and the control's, reached by
the same expression over the same limits (`control_correct`, which has to
come out false), the checks (program and control), end-to-end metrics and
notes. The benchmark's own runs never read the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    from pice_bench import harness, run as run_mod
    cell, config, traffic = run_mod.cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.Run(cell, config, traffic, seed, args.seconds, False,
                        "cuda", t, control=True)
        out = r.execute()
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "control_correct": r.control_correct,
                          "checks": r.readings, "metrics": out["metrics"],
                          "device": out["device"], "notes": r.notes,
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
