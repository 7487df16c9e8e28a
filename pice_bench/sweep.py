"""Find the highest rate a cell's open-loop mix is served at: one fleet,
one window a rate, rates in increasing order, each window as long as the
cell's own.

  python3 pice_bench/sweep.py --workload pice-dense.cloud-rag \
      --rates 3,3.5,4,4.5 --seconds 50

For each offered rate, prints one JSON line: requests due and answered per
second in the window, the median and 95th percentile of due time to answer
over the requests due in the window (waited for up to `--drain` seconds),
the 95th percentile of each half of the window, the backlog (due and not
yet answered) at the window's middle and at its close and its trend (the
least-squares slope of the backlog read every second), how late the
generator sent, and the share of the window the cloud engine spent in its
steps. A rate is sustained when every request due in the window was
answered, the answers returned in the window are at least 97 % of the
requests due in it, the backlog grows by less than 5 % of that rate, the
second half's 95th percentile is within 1.5 times the first's, and the
generator never ran a second late. The knee is the highest sustained rate
below the first rate that is not; a cell's rate is fixed below it in its
mix file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def backlog(answers, t: float) -> int:
    return sum(1 for a in answers if a.due <= t and (not a.done or a.done > t))


def slope(points) -> float:
    """Least-squares slope of [(t, y)]."""
    n = len(points)
    mt = sum(t for t, _ in points) / n
    my = sum(y for _, y in points) / n
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (y - my) for t, y in points) / var if var else 0.0


def window_stats(ctx, late, step_spans) -> dict:
    from pice_bench.yardstick import quantile
    t0, t1 = ctx.window
    mid = (t0 + t1) / 2
    due = [a for a in ctx.answers if t0 <= a.due <= t1]

    def p(answers, q):
        v = quantile([a.done - a.due for a in answers if a.ok], q)
        return None if v is None else 1e3 * v

    first = [a for a in due if a.due < mid]
    second = [a for a in due if a.due >= mid]
    busy = sum(min(e, t1) - max(s, t0) for s, e in step_spans
               if e > t0 and s < t1)
    out = {"due_per_s": len(due) / (t1 - t0),
           "answered_per_s": len(ctx.in_window()) / (t1 - t0),
           "p50_ms": p(due, 0.5), "p95_ms": p(due, 0.95),
           "p95_first_half_ms": p(first, 0.95),
           "p95_second_half_ms": p(second, 0.95),
           "backlog_mid": backlog(ctx.answers, mid),
           "backlog_close": backlog(ctx.answers, t1),
           "backlog_per_s": slope([(t, backlog(ctx.answers, t)) for t in
                                   (t0 + i for i in range(int(t1 - t0) + 1))]),
           "unanswered": sum(1 for a in due if not a.ok),
           "late_max_ms": 1e3 * max(late, default=0.0),
           "cloud_step_share": busy / (t1 - t0)}
    out["sustained"] = bool(
        out["unanswered"] == 0
        and out["answered_per_s"] >= 0.97 * out["due_per_s"]
        and out["backlog_per_s"] < 0.05 * out["due_per_s"]
        and None not in (out["p95_first_half_ms"], out["p95_second_half_ms"])
        and out["p95_second_half_ms"] <= 1.5 * out["p95_first_half_ms"]
        and out["late_max_ms"] < 1000.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--drain", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    from pice_bench import harness, run as run_mod
    cell, config, traffic = run_mod.cell_files(args.workload)
    fleet = harness.Fleet(config, traffic, args.seed, "cuda")
    knee, rec, unbroken = None, None, True
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(traffic, rate_rps=rate, drain_s=args.drain)
        r = harness.Run(cell, config, mix, args.seed + k, args.seconds,
                        False, "cuda", time.perf_counter())
        ctx = r.measure(fleet, install=rec is None)
        rec = rec or r.rec
        stats = window_stats(ctx, r.late, rec.spans["cloud.step"])
        print(json.dumps({"rate": rate, **stats}), flush=True)
        unbroken = unbroken and stats["sustained"]
        if unbroken:
            knee = rate
        for fe in [fleet.pipe.cloud, *fleet.pipe.edges.values()]:
            fe.abort_all()
    print(json.dumps({"knee": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
