"""idle_share.launch.<cells> (.closed, .rag): the traced sub-window's
share with no operation on the device while the host was launching model
work, in %: the innermost program span around the idle time is
`engine.ingest` (the eager ragged ingest), `engine.decode` (a decode
graph's replay or an eager decode) or `engine.prefix` (a fan-out's prefix
prefill)."""
from pice_bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "launch")
