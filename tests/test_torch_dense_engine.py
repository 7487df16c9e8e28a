"""The port's dense engine and monolithic paged engine (prefill_chunk == 0)
against the JAX package's engines on the same weights, and the port's own
invariants: dense == paged, monolithic == chunked, the monolithic fan-out
(suffixes teacher-forced through Slot.pending) == independent submissions,
eviction-resume == uninterrupted, the dense fan-out falls back to
independent submissions, one device->host read per dense decode step,
`score()`, and the launcher's dense fleet."""
import sys

import numpy as np
import pytest
import torch

from _torch_common import (PROMPTS, TINY, assert_close, assert_same_replay,
                           jax_config, params_pair)
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.core.profiler import RuntimeMonitor
from repro_torch.launch import serve
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.frontend import EngineFrontend


@pytest.fixture(scope="module")
def params():
    return params_pair(TINY)


def _engine(tp, backend="dense", chunk=0, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return InferenceEngine(TINY.with_(prefill_chunk=chunk), tp,
                           kv_backend=backend, device="cpu", **kw)


def _jax_engine(jp, backend="dense", **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return JEngine(jax_config(TINY), jp, kv_backend=backend, **kw)


@pytest.mark.parametrize("backend,page", [("dense", 16), ("paged", 8),
                                          ("paged", 16)])
def test_greedy_generate_matches_jax(params, backend, page):
    jp, tp = params
    want = _jax_engine(jp, backend, page_size=page).generate(PROMPTS,
                                                             max_new=12)
    eng = _engine(tp, backend, page_size=page)
    got = eng.generate(PROMPTS, max_new=12)
    assert_same_replay(got, want)
    if backend == "paged":
        assert eng.alloc.pages_in_use == 0


def test_dense_equals_paged_and_monolithic_equals_chunked(params):
    _, tp = params
    dense = _engine(tp).generate(PROMPTS, max_new=16)
    mono = _engine(tp, "paged").generate(PROMPTS, max_new=16)
    chunked = _engine(tp, "paged", chunk=16).generate(PROMPTS, max_new=16)
    assert_same_replay(dense, mono)
    assert_same_replay(mono, chunked)


def test_monolithic_fanout_matches_jax(params):
    """Fork suffixes (empty, one token, 20 tokens) are teacher-forced one
    token a step through Slot.pending."""
    jp, tp = params
    prefix = [(i % 100) + 1 for i in range(70)]
    suffixes = [[5, 6, 7], [9], [11] * 20, []]
    want = _jax_engine(jp, "paged", max_batch=5).generate_fanout(
        prefix, suffixes, max_new=8)
    eng = _engine(tp, "paged", max_batch=5)
    got = eng.generate_fanout(prefix, suffixes, max_new=8)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0
    assert all(not s.pending for s in eng.slots)


def test_monolithic_fanout_equals_independent_submissions(params):
    _, tp = params
    prefix = [(i % 90) + 3 for i in range(40)]
    suffixes = [[4, 5], [6] * 17, [7]]
    fan = _engine(tp, "paged", max_batch=4).generate_fanout(
        prefix, suffixes, max_new=8)
    indep = _engine(tp, "paged", max_batch=4).generate(
        [prefix + s for s in suffixes], max_new=8)
    assert_same_replay(fan, indep)


@pytest.mark.parametrize("fanout", [False, True])
def test_monolithic_eviction_resume_equals_uninterrupted(params, fanout):
    """A small pool evicts; the victims resume by a fresh prefill of prompt
    + carried tokens or, for a fork whose prefix is still parked, by
    re-forking and teacher-forcing suffix + carry through Slot.pending."""
    _, tp = params
    kw = dict(max_len=64, page_size=8)
    if fanout:
        prefix, suffixes = [65, 66, 67, 68, 69], [[70, 71], [72], [73, 74]]
        ref = _engine(tp, "paged", max_batch=4, **kw).generate_fanout(
            prefix, suffixes, max_new=24)
        small = _engine(tp, "paged", max_batch=4, n_pages=7,
                        host_swap=False, **kw)
        out = small.generate_fanout(prefix, suffixes, max_new=24)
    else:
        prompts = [[65, 66, 67, 68], [70, 71], [80, 81, 82]]
        ref = _engine(tp, "paged", **kw).generate(prompts, max_new=24)
        small = _engine(tp, "paged", n_pages=6, host_swap=False, **kw)
        out = small.generate(prompts, max_new=24)
    assert small.evictions > 0
    assert_same_replay(ref, out)
    assert small.alloc.pages_in_use == 0


def test_dense_fanout_falls_back_to_independent_submissions(params):
    _, tp = params
    prefix, suffixes = [1, 2, 3, 4], [[5], [6, 7]]
    eng = _engine(tp)
    fan = eng.generate_fanout(prefix, suffixes, max_new=6)
    indep = _engine(tp).generate([prefix + s for s in suffixes], max_new=6)
    assert fan == indep
    assert not any(s.parked for s in eng.slots)
    with pytest.raises(RuntimeError):
        eng.prefill_prefix(prefix)


def test_frontend_dense_fanout_falls_back(params):
    """The front-end's fan-out submits independent requests on the dense
    backend, exactly where the engine does."""
    _, tp = params
    prefix, suffixes = [9, 8, 7], [[1], [2, 3], []]
    via_frontend = EngineFrontend(_engine(tp)).generate_fanout(
        prefix, suffixes, max_new=5)
    direct = _engine(tp).generate_fanout(prefix, suffixes, max_new=5)
    assert via_frontend == direct


def test_one_readback_per_dense_decode_step(params, monkeypatch):
    """A dense decode step's tokens and logprobs come back as ONE
    device->host copy, at the next step's harvest."""
    _, tp = params
    eng = _engine(tp)
    eng.add_request(0, [1, 2, 3], max_new=6)
    eng.add_request(1, [4, 5], max_new=6)
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    n0 = len(eng.slots[0].tokens)
    assert eng.step() and reads == []          # launch, nothing to harvest
    assert len(eng.slots[0].tokens) == n0
    for k in range(1, 4):
        assert eng.step()
        assert reads == [(2, eng.max_batch)] * k
        assert len(eng.slots[0].tokens) == n0 + k


def test_dense_window_peak_and_memory_stats(params):
    """Dense telemetry counts slots as pages, and the windowed peak
    survives the drain between synchronous requests
    (tests/test_engine.py::test_dense_consume_peak_is_windowed)."""
    _, tp = params
    eng = _engine(tp)
    eng.generate([[1, 2, 3], [4, 5], [6]], max_new=4)
    st = eng.memory_stats()
    assert st["backend"] == "dense" and st["pages_total"] == 3
    assert st["pages_in_use"] == 0 and st["utilization"] == 0.0
    mon = RuntimeMonitor()
    mon.observe_engines([eng])
    assert mon.kv_pages_used == 3
    assert eng.consume_peak() == 0              # window reset


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_inactive_slot_lengths_do_not_drift(params, backend):
    _, tp = params
    eng = _engine(tp, backend, max_batch=2, max_len=64)
    s1 = eng.add_request(1, [8, 9, 10], max_new=40)
    s0 = eng.add_request(0, [5, 6, 7], max_new=1)
    assert s0 != s1 and not eng.slots[s0].active
    frozen = eng.slots[s0].ctx_len
    while eng.slots[s1].active:
        eng.step()
    lens = eng.cache["lengths"].numpy()
    assert lens[s0] == frozen and lens[s1] <= eng.max_len


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_context_capacity_terminates_like_jax(params, backend):
    """A prompt longer than max_len keeps its tail; decoding stops at
    context capacity."""
    jp, tp = params
    prompts = [[(7 * i) % 120 + 1 for i in range(70)], [3, 4]]
    want = _jax_engine(jp, backend, max_len=64).generate(prompts, max_new=20)
    got = _engine(tp, backend, max_len=64).generate(prompts, max_new=20)
    assert_same_replay(got, want)


@pytest.mark.parametrize("n", [1, 2, 37, 200])
def test_score_matches_jax(params, n):
    """Sequences shorter than a bucket, and longer than max_len (scored on
    their tail)."""
    jp, tp = params
    toks = [(11 * i) % 127 + 1 for i in range(n)]
    want = _jax_engine(jp).score(toks)
    got = _engine(tp).score(toks)
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])


def test_serve_dense_fleet_on_cpu(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --kv-backend dense` serves the
    TINY fleet (each config with its own, monolithic, prefill_chunk)."""
    monkeypatch.setattr(serve, "build_pipeline", _quick_pipeline(serve))
    monkeypatch.setattr(sys, "argv", [
        "serve", "--kv-backend", "dense", "--train-steps", "0",
        "--requests", "1", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "1 requests in" in out


def _quick_pipeline(serve):
    """build_pipeline with two profile lengths, and a check that every
    engine is dense and monolithic."""
    real = serve.build_pipeline

    def build(engines, caps, **kw):
        assert all(e.kv_backend == "dense" and e.prefill_chunk == 0
                   for e in engines.values())
        kw["profile_lengths"] = (4, 8)
        return real(engines, caps, **kw)
    return build


def test_served_fleet_keeps_its_configs_prefill_chunk():
    engines, _ = serve.build_engines(device="cpu", names=("tiny-edge-b",))
    eng = engines["tiny-edge-b"]
    assert eng.kv_backend == "paged" and eng.prefill_chunk == 0
    assert np.all(eng.block_table == -1)
