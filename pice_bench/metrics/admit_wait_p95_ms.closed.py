"""admit_wait_p95_ms.closed: the 95th percentile of a request's wait in a
front-end for an engine slot (the program's `frontend.queued` span, from
submission to admission, shedding or cancellation; sketches, full cloud
answers and expansion forks alike), in ms, over the waits that ended in
the window (the traced run's sub-window, where the program records
them)."""
from pice_bench.program_spans import span_ms
from pice_bench.yardstick import quantile


def read(ctx):
    return quantile(span_ms(ctx, "frontend.queued") or [], 0.95)
