"""mfu.<cells> (mfu.closed, mfu.rag): the whole step's share of the
card's bf16 peak in the traced sub-window, in %: the operations of every
token both engines processed (2 x the matmul weights it passes, attention
over its keys, and the unembedding of each call's logits rows) over the
sub-window's wall x 989 TFLOP/s."""
from pice_bench.yardstick import PEAK_FLOPS, step_flops, window_rows


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    flops = sum(step_flops(ctx.spec(role), rows)
                for role, _, rows in window_rows(ctx))
    if flops <= 0:
        return None
    peak = PEAK_FLOPS[ctx.spec("cloud")["dtype"]]
    return 100.0 * flops / (t.window_s * peak)
