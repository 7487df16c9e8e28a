"""Step inspector: where one (architecture x shape) step's flops and bytes
go (the JAX package's `launch/inspect_hlo.py`, which reads them from the
compiled HLO of the production mesh).

    PYTHONPATH=src python -m repro_torch.launch.inspect_step \\
        --arch granite-3-8b --shape decode_32k --top 25

By default the step runs under fake tensors (`launch/dryrun.build_step`,
the plain path) and the top aten ops are printed by bytes and by flops,
grouped by (op, operand shapes) as the reference groups HLO ops by
(opcode, shape). With `--device cuda` the same step runs for real on the
card at full width (random weights from a seed, the kernels' path) when
the dry-run says it fits, and the top kernels by device time under
`torch.profiler` are printed. The reference's `--collectives` lists the
collectives of a partitioned HLO module: XLA-only, the port's step calls
none.
"""
from __future__ import annotations

import argparse

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.configs.registry import SHAPES
from repro_torch.distributed import cost_analysis
from repro_torch.launch.dryrun import build_step, dryrun_config, run_one


def top_ops(arch: str, shape_name: str, top: int = 25):
    """The step's per-op table under fake tensors -> (StepCost, rows by
    bytes, rows by flops); a row is (signature, calls, flops, bytes)."""
    shape = SHAPES[shape_name]
    cfg = dryrun_config(registry.get_config(arch), shape)
    with FakeTensorMode():
        fn, args = build_step(cfg, shape)
        _, cost = cost_analysis.measure(fn, args, by_op=True)
    rows = [(k, n, f, b) for k, (n, f, b) in cost.by_op.items()]
    by_bytes = sorted(rows, key=lambda r: -r[3])[:top]
    by_flops = sorted((r for r in rows if r[2]), key=lambda r: -r[2])[:top]
    return cost, by_bytes, by_flops


def top_kernels(arch: str, shape_name: str, top: int = 25, runs: int = 3):
    """The step on the card (random bf16 weights from seed 0), profiled
    over `runs` calls after one warm call -> [(kernel, ms a call, calls a
    call)] by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    shape = SHAPES[shape_name]
    cfg = dryrun_config(registry.get_config(arch), shape)
    fn, args = build_step(cfg, shape, device="cuda")
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / runs, e.count / runs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "inspect_step")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="fake", choices=["fake", "cuda"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        rec = run_one(args.arch, args.shape, "h100x1")
        if rec["status"] != "ok" or not rec["fits"]:
            print(f"{args.arch} x {args.shape} does not run on one card: "
                  f"{rec['status']}, fits={rec.get('fits')}")
            return 1
        print(f"== top {args.top} kernels by device time a step "
              f"({args.arch} x {args.shape}, one card) ==")
        for key, ms, n in top_kernels(args.arch, args.shape, args.top):
            print(f"{ms:10.4f} ms  x{n:6.0f}  {key[:100]}")
        return 0
    cost, by_bytes, by_flops = top_ops(args.arch, args.shape, args.top)
    print(f"== top {args.top} op groups by bytes accessed "
          f"({args.arch} x {args.shape}, plain path under fake tensors) ==")
    for key, n, _, b in by_bytes:
        print(f"{b / 1e9:12.2f} GB  x{n:5d}  {key[:110]}")
    print(f"\n== top {args.top} op groups by flops ==")
    for key, n, f, _ in by_flops:
        print(f"{f / 1e12:12.3f} TF  x{n:5d}  {key[:110]}")
    print(f"\ncost: flops={cost.flops:.3e} bytes={cost.bytes_accessed:.3e} "
          f"unique={cost.unique_bytes:.3e} peak={cost.peak_bytes:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
