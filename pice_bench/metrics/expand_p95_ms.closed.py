"""expand_p95_ms.closed: the 95th percentile of the edge expansion call
(`generate_fanout_async`: prefix prefill, fork, suffix, decode), in ms,
over the calls that ended in the window."""
from pice_bench.yardstick import quantile, span_seconds


def read(ctx):
    v = quantile(span_seconds(ctx, "edge.expand"), 0.95)
    return None if v is None else 1e3 * v
