"""The port's load generator (serving/loadgen.py) against the JAX package's:
the same seeded Poisson traces entry for entry, the same prompts, JSONL
traces readable by either, and a replay through `EngineFrontend` that gives
the same token content as the JAX front-end's on the same weights, over a
roomy pool and over one that evicts (host swap, the default, on both)."""
import numpy as np
import pytest

from _torch_common import TINY, jax_config, params_pair
from repro.serving import frontend as jfrontend
from repro.serving import loadgen as jloadgen
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.core.profiler import RuntimeMonitor
from repro_torch.serving import loadgen
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.frontend import EngineFrontend


@pytest.fixture(scope="module")
def params():
    return params_pair(TINY)


KW = dict(max_batch=4, max_len=128, page_size=8)


@pytest.mark.parametrize("rate,n,seed,kw", [
    (50.0, 20, 3, {}),
    (4.0, 16, 0, dict(prompt_len=(300, 400), max_new=(100, 160))),
    (200.0, 6, 1, dict(prompt_len=(3, 8), max_new=(4, 8),
                       tier_mix={"batch": 1.0})),
])
def test_synthesize_trace_equals_reference(rate, n, seed, kw):
    got = loadgen.synthesize_trace(rate, n, seed=seed, **kw)
    want = jloadgen.synthesize_trace(rate, n, seed=seed, **kw)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got != loadgen.synthesize_trace(rate, n, seed=seed + 1, **kw)


def test_trace_prompt_equals_reference():
    for seed, index, plen, vocab in ((3, 5, 8, 128), (0, 0, 1, 2),
                                     (7, 15, 384, 151936)):
        assert loadgen.trace_prompt(seed, index, plen, vocab) \
            == jloadgen.trace_prompt(seed, index, plen, vocab)


def test_traces_roundtrip_between_packages(tmp_path):
    trace = loadgen.synthesize_trace(50.0, 12, seed=5)
    p = tmp_path / "trace.jsonl"
    loadgen.save_trace(str(p), trace)
    assert loadgen.load_trace(str(p)) == trace
    assert [vars(e) for e in jloadgen.load_trace(str(p))] \
        == [vars(e) for e in trace]


def _replay(fe, lg, trace):
    """Replay with every arrival at once (time_scale 0) and deadlines far
    away, keeping the handles in submission order."""
    handles = []
    submit = fe.submit

    def keep(req, sheddable=True):
        h = submit(req, sheddable=sheddable)
        handles.append(h)
        return h
    fe.submit = keep
    report = lg.replay_sync(fe, trace, seed=2, time_scale=0.0,
                            tier_budget_s=1e6)
    return report, handles


@pytest.mark.parametrize("n_pages", [None, 12])
def test_replay_matches_jax_frontend(params, n_pages):
    """16 requests of 4-24 prompt tokens and 8-48 new ones on 4 slots; a
    pool of 12 pages of 8 evicts (the largest request needs 9)."""
    jp, tp = params
    trace = loadgen.synthesize_trace(100.0, 16, seed=2)
    eng = InferenceEngine(TINY.with_(prefill_chunk=16), tp, device="cpu",
                          n_pages=n_pages, **KW)
    jeng = JEngine(jax_config(TINY.with_(prefill_chunk=16)), jp,
                   kv_backend="paged", n_pages=n_pages, **KW)
    got, hs = _replay(EngineFrontend(eng), loadgen, trace)
    want, jhs = _replay(jfrontend.EngineFrontend(jeng), jloadgen, trace)
    if n_pages:
        assert eng.evictions > 0 and eng.swap_outs > 0
    assert (got.completed, got.shed, got.failed, got.total_tokens) \
        == (want.completed, want.shed, want.failed, want.total_tokens)
    assert got.completed == 16
    for h, jh in zip(hs, jhs):
        assert h.state == jh.state == "done"
        assert h.tokens == jh.tokens
        np.testing.assert_allclose(h.logprobs, jh.logprobs, rtol=1e-5,
                                   atol=1e-6)
    assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted


def test_replay_reports_outcomes_and_arrival_relative_ttft(params):
    """tests/test_frontend.py's replay test on the port."""
    _, tp = params
    mon = RuntimeMonitor()
    eng = InferenceEngine(TINY.with_(prefill_chunk=16), tp, device="cpu",
                          **KW)
    fe = EngineFrontend(eng, monitor=mon, queue_max=32)
    trace = loadgen.synthesize_trace(200.0, 6, seed=1, prompt_len=(3, 8),
                                     max_new=(4, 8), tier_mix={"batch": 1.0})
    report = loadgen.replay_sync(fe, trace, seed=1, offered_rps=200.0)
    assert report.n_requests == 6
    assert report.completed == 6 and report.shed == 0 and report.failed == 0
    assert report.sla_attainment == 1.0
    assert report.good_tokens == report.total_tokens > 0
    assert report.goodput_tps > 0
    assert len(mon.ttft_window) == 6
    assert report.ttft_p95_s >= report.ttft_p50_s > 0
    assert report.latency_p95_s >= report.ttft_p50_s
    s = report.summary()
    assert s["goodput_tps"] == report.goodput_tps
    assert s["per_tier_met"] == {"batch": 6}


def test_sweep_replays_the_same_workload_at_each_load(params):
    _, tp = params
    made = []

    def factory():
        made.append(EngineFrontend(InferenceEngine(
            TINY.with_(prefill_chunk=16), tp, device="cpu", **KW)))
        return made[-1]
    reports = loadgen.sweep(factory, 400.0, 4, load_multipliers=(1.0, 2.0),
                            prompt_len=(3, 6), max_new=(2, 4),
                            tier_budget_s=1e6)
    assert [r.offered_rps for r in reports] == [400.0, 800.0]
    assert len(made) == 2
    assert all(r.completed == 4 and r.n_requests == 4 for r in reports)
    assert reports[0].total_tokens == reports[1].total_tokens
