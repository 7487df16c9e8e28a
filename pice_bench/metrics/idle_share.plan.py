"""idle_share.plan.<cells> (.closed, .rag): the traced sub-window's share
with no operation on the device while the host was planning an engine
step, in %: the innermost program span around the idle time is
`engine.step` itself (its own time: harvest bookkeeping, ragged-row
building, the first draws' sampling), `engine.plan`, `engine.commit`,
`engine.readback` or `engine.admit`."""
from pice_bench.program_spans import idle_share


def read(ctx):
    return idle_share(ctx, "plan")
