"""Known-bad captured-buffer snippets (RA301): an engine that rebinds the
tensors its captured graph holds. Parsed, never run."""
import torch

from repro_torch.models import transformer


class Engine:
    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params
        self.cache = transformer.init_cache(cfg, 4, 64)

    def warmup(self):
        self._capture_decode(1)

    def _capture_decode(self, live):
        self._graph_io = torch.zeros(4)
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            pass

    def reset(self, cfg):
        self.cache = transformer.init_cache(cfg, 4, 64)     # expect: RA301

    def reload(self, params):
        self.params = params                                # expect: RA301

    def step(self, tokens):
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, tokens, self.cache)      # in place
        return logits
