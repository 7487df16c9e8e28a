"""roofline.decode_attn.closed: the paged decode attention kernels' share
of their roofline in the traced sub-window, in %: the bytes the decode
rows need (each row's K/V over its keys, its query and output, every
attention layer, both engines) over 3.35 TB/s, against the summed device
time of the paged decode kernels."""
from pice_bench.yardstick import (PEAK_BYTES_PER_S, decode_attention_bytes,
                                  kernel_seconds, window_rows)


def read(ctx):
    secs = kernel_seconds(ctx, "decode_kernel")
    if secs <= 0:
        return None
    need = sum(decode_attention_bytes(ctx.spec(role), [o for o, _ in rows])
               for role, _, rows in window_rows(ctx, kind="decode"))
    return 100.0 * need / PEAK_BYTES_PER_S / secs
