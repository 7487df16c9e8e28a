"""setup_s: process start to the window's start (weights, engines,
warm-up, kernel loading or building, and the mix's ramp)."""


def read(ctx):
    return ctx.setup_s
