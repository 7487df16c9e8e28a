"""device_idle_share.<cells> (.closed, .rag): the traced sub-window's
share with no operation on the device, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
