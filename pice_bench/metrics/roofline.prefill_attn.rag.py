"""roofline.prefill_attn.rag: the ragged paged prefill attention kernels'
share of their roofline in the traced sub-window, in %: for each batched
ingest call the larger of its attention operations over 989 TFLOP/s and
its bytes over 3.35 TB/s, against the summed device time of the paged
prefill kernels."""
from pice_bench.yardstick import (kernel_seconds, prefill_attention_bound_s,
                                  window_rows)


def read(ctx):
    secs = kernel_seconds(ctx, "paged_prefill_kernel")
    if secs <= 0:
        return None
    bound = sum(prefill_attention_bound_s(ctx.spec(role), rows)
                for role, _, rows in window_rows(ctx, kind="ingest"))
    return 100.0 * bound / secs
