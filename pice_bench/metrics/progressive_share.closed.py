"""progressive_share.closed: the share of the window's answers that took
the progressive path whole (`Response.mode`, not degraded), in %."""


def read(ctx):
    done = ctx.in_window()
    if not done:
        return None
    return 100.0 * sum(1 for a in done if a.ok and a.mode == "progressive") \
        / len(done)
