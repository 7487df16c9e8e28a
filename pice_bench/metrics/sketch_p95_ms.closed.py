"""sketch_p95_ms.closed: the 95th percentile of the cloud sketch call (the
program's `pipeline.sketch` span: the wait for a cloud slot, the ingest
of the sketch prompt and its decode), in ms, over the sketches that ended
in the window. The program records the spans of a traced run's
sub-window only, so a sketch longer than that sub-window is not seen."""
from pice_bench.program_spans import span_ms
from pice_bench.yardstick import quantile


def read(ctx):
    return quantile(span_ms(ctx, "pipeline.sketch") or [], 0.95)
