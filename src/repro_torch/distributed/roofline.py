"""Roofline terms of a dry-run record on the NVIDIA H100 (the JAX package's
`distributed/roofline.py`, whose hardware model is a TPU v5e).

Hardware model: an NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet
figures, not measurements: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, 450 GB/s of NVLink each way. A record's numbers are
per card, so the terms are per card:

    compute    = flops_dev / peak
    memory     = bytes_accessed_dev / hbm_bw
    collective = collective_bytes_dev / link_bw

MODEL_FLOPS is the analytic useful compute: 6*N*D for training (forward
and backward), 2*N*D for forward-only (prefill / decode), N the active
params for a MoE. The ratio MODEL_FLOPS / counted flops shows the work
that is not useful: remat, a MoE's products over every expert, plain
attention's masked half.

`scan_undercount` is always False here: XLA's static cost analysis counts
a `lax.scan` body once, where the port's step runs eagerly under
`FlopCounterMode`, which counts every iteration of every loop. The field
is kept so that rows of both packages compare.

`row_from_record` also reads the JAX package's records (pod meshes, XLA's
per-device cost analysis): their terms are then that per-device work at
the H100's rates.

    python -m repro_torch.distributed.roofline artifacts/dryrun_torch --mesh h100x1

prints a sweep's records as a table (terms in ms, the byte bound from the
unique bytes, the peak against 80 GB, each pair's seconds on the host).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional

from repro_torch.configs.registry import SHAPES, InputShape, get_config
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12        # dense bf16, tensor cores (datasheet)
HBM_BW = 3.35e12           # HBM3 (datasheet)
LINK_BW = 450e9            # NVLink 4, each way (datasheet)
CARD_BYTES = 80e9          # "80 GB" of HBM3
CHIPS = {"h100x1": 1, "h100x4": 4, "pod16x16": 256, "pod2x16x16": 512}


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs for the whole step (global, all cards)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # one token a sequence


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_dev: float = 0.0      # counted flops a card (the field's name
                                    # is the reference's)
    useful_ratio: float = 0.0
    temp_bytes: Optional[int] = None
    scan_undercount: bool = False
    note: str = ""

    def dominant_value(self) -> float:
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}[self.dominant]


def row_from_record(rec: dict) -> RooflineRow:
    arch, shape_name, mesh = rec["arch"], rec["shape"], rec["mesh"]
    if rec["status"] != "ok":
        return RooflineRow(arch=arch, shape=shape_name, mesh=mesh,
                           status=rec["status"],
                           note=rec.get("reason", rec.get("error", ""))[:120])
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    compute = rec["flops"] / PEAK_FLOPS
    memory = rec["bytes_accessed"] / HBM_BW
    coll = rec["collective_bytes"]["total"] / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    flops_global = rec["flops"] * CHIPS[mesh]
    return RooflineRow(
        arch=arch, shape=shape_name, mesh=mesh, status="ok",
        compute_s=compute, memory_s=memory, collective_s=coll, dominant=dom,
        model_flops=mf, hlo_flops_dev=rec["flops"],
        useful_ratio=mf / max(flops_global, 1.0),
        temp_bytes=rec["memory"]["temp_bytes"])


def load_rows(art_dir: str, mesh: str = "h100x1", tag: str = "") -> list:
    rows = []
    for f in sorted(Path(art_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("mesh") != mesh or rec.get("tag", "") != tag:
            continue
        rows.append(row_from_record(rec))
    return rows


def suggestion(row: RooflineRow) -> str:
    """One sentence on what would move the dominant term down."""
    if row.status != "ok":
        return ""
    if row.dominant == "collective":
        return ("reduce cross-card traffic: overlap the gradient all-reduce "
                "with the backward, or shard optimizer state instead of "
                "replicating it")
    if row.dominant == "memory":
        if row.shape.startswith("decode") or row.shape == "long_500k":
            return ("decode is KV-bound: shorter outputs (PICE sketching), "
                    "windowed/quantized KV, or a cache split over cards")
        return ("cast/fuse activations (bf16 residuals, fused norm), tighter "
                "remat policy, or hand-written kernels in place of the plain "
                "attention's materialized scores")
    return ("raise tensor-core utilization: larger GEMM tiles, fewer "
            "padded dims, fused matmuls")


def table(art_dir: str, mesh: str = "h100x1", tag: str = "") -> str:
    """A markdown table of a sweep's records on `mesh`: the terms and the
    byte bound in ms, the useful ratio, argument and peak bytes a card (a
    pod record's argument bytes a device), whether the peak fits, and the
    pair's seconds on the host."""
    out = ["| arch | shape | status | compute ms | memory ms | collective ms "
           "| byte bound ms | dominant | useful | args GB | peak GB | fits | "
           "host s |", "|" + " --- |" * 13]
    for f in sorted(Path(art_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("mesh") != mesh or rec.get("tag", "") != tag:
            continue
        row = row_from_record(rec)
        cells = [""] * 6
        if row.status == "ok":
            terms = (row.compute_s, row.memory_s, row.collective_s,
                     rec.get("unique_bytes", 0) / HBM_BW)
            cells = [f"{t * 1e3:.4g}" for t in terms] + [
                row.dominant, f"{row.useful_ratio:.3f}"]
        mem = rec.get("memory", {})
        sizes = [f"{mem[k] / 1e9:.2f}" if mem.get(k) is not None else ""
                 for k in ("argument_bytes", "peak_bytes")]
        out.append("| " + " | ".join(
            [row.arch, row.shape, row.status, *cells, *sizes,
             str(rec.get("fits", "")), str(rec.get("seconds", ""))]) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.distributed."
                                      "roofline")
    ap.add_argument("dir")
    ap.add_argument("--mesh", default="h100x1")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(table(args.dir, args.mesh, args.tag))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
