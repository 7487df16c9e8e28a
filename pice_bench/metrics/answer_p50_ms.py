"""answer_p50_ms: the median of due time to answer returned, in ms, over
the measured answers that returned whole."""
from pice_bench.yardstick import quantile


def read(ctx):
    v = quantile([a.done - a.due for a in ctx.measured() if a.ok], 0.5)
    return None if v is None else 1e3 * v
