"""Known-bad graph-capture snippets (RA2xx). Lines marked `# expect: CODE`
are asserted exactly by tests/test_torch_analysis.py; parsed, never run."""
import torch


def _bucket(n, lo=32):                  # no clamp inside
    b = lo
    while b < n:
        b *= 2
    return b


def capture_anywhere(fn):
    g = torch.cuda.CUDAGraph()          # expect: RA202
    with torch.cuda.graph(g):           # expect: RA202
        fn()
    return g


class Engine:
    def __init__(self):
        self._graphs = {}

    def width(self, tokens):
        return _bucket(len(tokens))     # expect: RA201

    def warmup(self):
        self._capture_decode(len(self.prompt))      # expect: RA203

    def _capture_decode(self, live):
        self._graphs[live] = torch.cuda.CUDAGraph()     # expect: RA202

    def _capture_prefill(self, rows):                   # expect: RA205
        with torch.cuda.graph(self._graphs[rows]):      # expect: RA202
            pass

    def step(self, slot, n):
        g = self._graphs.get(slot.ctx_len)              # expect: RA203
        h = self._graphs[n]                             # expect: RA203
        return g, h
