"""idle_share.serve.<cells> (.closed): the traced sub-window's share with
no operation on the device while the host was in no engine span, in %:
the front-ends' drivers, the pipeline's host sections and the event loop.
With `idle_share.plan` and `idle_share.launch` it sums to
`device_idle_share`."""
from pice_bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "serve")
