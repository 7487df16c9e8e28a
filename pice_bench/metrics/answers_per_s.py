"""answers_per_s: answers returned whole in the window over its length."""


def read(ctx):
    t0, t1 = ctx.window
    return sum(1 for a in ctx.in_window() if a.ok) / (t1 - t0)
