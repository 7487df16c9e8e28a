"""cloud_ttft_p95_ms.rag: the 95th percentile of the cloud calls' time to
first token (`RequestHandle.ttft_s`, from the call's submission), in ms,
over the first tokens that came in the window."""
from pice_bench.yardstick import quantile


def read(ctx):
    t0, t1 = ctx.window
    v = quantile([s for t, s in ctx.ttft.get("cloud", ()) if t0 <= t <= t1],
                 0.95)
    return None if v is None else 1e3 * v
