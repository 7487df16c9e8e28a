"""A cell run end to end on the CPU at a tiny size: the configurations and
mixes in `data/`, the harness with the chip check skipped."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
ROOT = DATA.parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pice_bench import harness  # noqa: E402

CELLS = {"dense": ("tiny-dense", "tiny-progressive", "pice-dense.progressive"),
         "hybrid": ("tiny-hybrid", "tiny-progressive",
                    "pice-dense.progressive"),
         "rag": ("tiny-dense", "tiny-cloud-rag", "pice-dense.cloud-rag")}


def load(name: str) -> dict:
    with open(DATA / f"{name}.json") as f:
        return json.load(f)


def run(kind: str, seed: int = 2_300_000_017, trace: bool = False,
        seconds: float = 10.0, control: bool = False):
    """(result, run) of a tiny cell on the CPU."""
    conf, mix, name = CELLS[kind]
    cell = {"name": name, "config": conf, "traffic": mix, "chips": 1}
    r = harness.Run(cell, load(conf), load(mix), seed, seconds, trace, "cpu",
                    time.perf_counter(), limits=load(conf + ".limits"),
                    control=control)
    return r.execute(), r
