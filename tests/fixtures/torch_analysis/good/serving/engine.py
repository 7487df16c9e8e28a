"""An engine that keeps the contracts: bucketed, clamped graph keys, every
capture reached from warmup(), tensors updated in place, one read a step in
`_harvest`. Parsed, never run."""
import torch

from repro_torch.models import transformer


def _bucket(n, lo=32):
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, cfg, params, max_len):
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.cache = transformer.init_cache(cfg, 4, max_len)
        self._graphs = {}
        self._graph_io = None
        self._pending = None

    def _live_pages(self, active):
        return min(_bucket(max(active) + 1), self.max_len)

    def warmup(self):
        for live in sorted({min(_bucket(n), self.max_len) for n in (1, 64)}):
            self._capture_decode(live)

    def _capture_decode(self, live):
        self._graph_io = torch.zeros(4)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            pass
        self._graphs[live] = graph

    def step(self, tokens, active):
        live = self._live_pages(active)
        graph = self._graphs.get(live)
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, tokens, self.cache)
        self._pending = logits
        return graph

    def _harvest(self):
        host = self._pending.cpu().numpy()
        return [int(v) for v in host[0]]
