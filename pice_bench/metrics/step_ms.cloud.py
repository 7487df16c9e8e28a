"""step_ms.cloud.<cells> (.closed, .rag): the cloud engine's step wall in
the window over its steps, in ms (the harness's span around
`InferenceEngine.step`, which ends in its one read back)."""
from pice_bench.yardstick import span_seconds


def read(ctx):
    v = span_seconds(ctx, "cloud.step")
    return 1e3 * sum(v) / len(v) if v else None
