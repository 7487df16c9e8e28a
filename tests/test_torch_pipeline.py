"""The port's PICEPipeline on the TINY cloud/edge fleet on the CPU against
the JAX package's pipeline on the same weights: with fixed latency models in
place of profiling and no deadline, two corpus requests take the same modes
and produce the same cloud and edge token counts, on chunked paged engines
and on dense engines."""
import pytest

from _torch_common import CONFIGS, jax_config, params_pair
from repro.core.profiler import LatencyModel as JLatency
from repro.core.progressive import PICEPipeline as JPipeline
from repro.core.scheduler import EdgeModelInfo as JEdgeInfo
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.requests import Request as JRequest
from repro_torch.core.profiler import LatencyModel
from repro_torch.core.progressive import PICEConfig, PICEPipeline
from repro_torch.core.scheduler import EdgeModelInfo
from repro_torch.data import corpus
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.requests import Request

NAMES = ("tiny-cloud", "tiny-edge-a", "tiny-edge-b")
LATENCY = {"tiny-cloud": (0.05, 40.0), "tiny-edge-a": (0.02, 90.0),
           "tiny-edge-b": (0.02, 110.0)}
CAPS = {"tiny-edge-a": 0.7, "tiny-edge-b": 0.55}
ENGINE_KW = dict(max_batch=8, max_len=256, page_size=16)


def _run(port: bool, weights, backend: str = "paged"):
    engines = {}
    for name in NAMES:
        cfg = CONFIGS[name].with_(prefill_chunk=64)
        jp, tp = weights[name]
        engines[name] = (
            InferenceEngine(cfg, tp, name=name, device="cpu",
                            kv_backend=backend, **ENGINE_KW)
            if port else JEngine(jax_config(cfg), jp, name=name,
                                 kv_backend=backend, **ENGINE_KW))
    lat = LatencyModel if port else JLatency
    info = EdgeModelInfo if port else JEdgeInfo
    infos = [info(name=n, latency=lat(*LATENCY[n], name=n),
                  capability=CAPS[n]) for n in NAMES[1:]]
    pipe_cls = PICEPipeline if port else JPipeline
    pipe = pipe_cls(engines["tiny-cloud"],
                    {n: engines[n] for n in NAMES[1:]},
                    lat(*LATENCY["tiny-cloud"], name="tiny-cloud"), infos,
                    cfg=PICEConfig(ensemble_size=2))
    req = Request if port else JRequest
    out = []
    for ex in corpus.corpus(2, seed=7):
        resp = pipe.handle(req(query=ex.query, category=ex.category,
                               max_new_tokens=64))
        out.append((resp.mode, resp.cloud_tokens, resp.edge_tokens,
                    resp.model_used, resp.degraded))
    return out


@pytest.fixture(scope="module")
def weights():
    return {n: params_pair(CONFIGS[n], seed=i) for i, n in enumerate(NAMES)}


def test_pipeline_matches_jax(weights):
    got = _run(True, weights)
    want = _run(False, weights)
    assert got == want
    assert any(mode == "progressive" for mode, *_ in got)


def test_dense_pipeline_matches_jax(weights):
    got = _run(True, weights, "dense")
    assert got == _run(False, weights, "dense")
