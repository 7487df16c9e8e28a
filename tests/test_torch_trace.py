"""The port's tracer (`repro_torch.trace`) on the CPU: nothing recorded
while off; under a running `torch.profiler` the spans of a tiny cloud-edge
pipeline get their parents and request ids right across asyncio tasks,
the front-end's driver included; the ring is bounded; and the Chrome-trace
export sits on the profiler's clock."""
import asyncio
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.configs.pice_cloud_edge import TINY_EDGE_A
from repro_torch.core.profiler import LatencyModel
from repro_torch.core.progressive import PICEConfig, PICEPipeline
from repro_torch.core.scheduler import EdgeModelInfo
from repro_torch.data import corpus
from repro_torch.models import transformer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.requests import Request

CFG = TINY_EDGE_A.with_(dtype="float32", prefill_chunk=32)


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def params():
    return [transformer.init_params(CFG, seed=s, device="cpu")
            for s in (0, 1)]


def _pipeline(params):
    cloud, edge = (InferenceEngine(CFG, p, name=n, device="cpu", max_batch=4,
                                   max_len=256, page_size=16)
                   for p, n in zip(params, ("cloud", "edge")))
    return PICEPipeline(
        cloud, {"edge": edge}, LatencyModel(0.05, 40.0, name="cloud"),
        [EdgeModelInfo(name="edge", latency=LatencyModel(0.02, 90.0,
                                                         name="edge"),
                       capability=0.7)], cfg=PICEConfig(ensemble_size=1))


def _answer_two(pipe):
    async def both():
        return await asyncio.gather(*[
            pipe.handle_async(Request(query=e.query, category=e.category,
                                      max_new_tokens=56))
            for e in corpus.corpus(2, seed=7)])
    return asyncio.run(both())


def test_off_records_nothing(params):
    assert not trace.on()
    with trace.span("engine.step") as sp:
        assert sp is None
    assert trace.begin("frontend.queued") is None
    trace.end(None)
    out = _answer_two(_pipeline(params))
    assert [r.mode for r in out] == ["progressive"] * 2
    assert trace.spans() == []


def test_parents_follow_tasks_under_a_running_profiler(params):
    pipe = _pipeline(params)
    with profile(activities=[ProfilerActivity.CPU]):
        out = _answer_two(pipe)
    assert [r.mode for r in out] == ["progressive"] * 2
    done = trace.spans()
    by_id = {s.id: s for s in done}
    names = {s.name for s in done}
    assert {"pipeline.answer", "pipeline.route", "pipeline.sketch",
            "pipeline.plan", "pipeline.expand", "pipeline.ensemble",
            "frontend.queued", "frontend.tick", "engine.step",
            "engine.readback", "engine.commit", "engine.plan",
            "engine.ingest", "engine.decode", "engine.prefix",
            "engine.admit"} <= names

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    answers = {s.req_id: s for s in done if s.name == "pipeline.answer"}
    assert sorted(answers) == sorted(r.req_id for r in out)
    for rid, a in answers.items():
        assert a.parent is None and a.awaits
        assert a.attrs == {"mode": "progressive", "degraded": ""}
    for s in done:
        r = root(s)
        if r.name == "pipeline.answer":
            # every span made on an answer's behalf carries its id
            assert s.req_id == r.req_id, s
        else:
            # the front-ends' drivers, started from inside the first
            # answers' submissions, run in contexts of their own
            assert r.name == "frontend.tick" and s.req_id is None, s
    for s in done:
        if s.name == "frontend.queued":
            parent = by_id[s.parent]
            assert parent.name in ("pipeline.sketch", "pipeline.expand")
            assert s.attrs["outcome"] == "admitted"
            assert s.attrs["role"] == ("sketch" if parent.name ==
                                       "pipeline.sketch"
                                       else "expansion_primary")
        elif s.name == "engine.step":
            assert by_id[s.parent].name == "frontend.tick"
            assert s.attrs["engine"] in ("cloud", "edge")
        elif s.name in ("engine.readback", "engine.commit", "engine.plan",
                        "engine.ingest", "engine.decode"):
            assert by_id[s.parent].name in ("engine.step", "engine.admit")
        elif s.name == "engine.prefix":
            assert by_id[s.parent].name == "pipeline.expand"
            n = sum(c for _, c in s.attrs["chunks"])
            assert [o for o, _ in s.attrs["chunks"]] == list(range(0, n, 32))
    steps = [s for s in done if s.name == "engine.step" and "decode" in s.attrs]
    assert any(s.attrs["decode"] for s in steps)
    assert any(s.attrs["ingest"] for s in steps)
    assert all(s.attrs["graph"] is False for s in steps)
    assert all(s.attrs["ingest_graph"] is False for s in steps)
    # the profiler stopped: nothing more is recorded
    n = len(trace.spans())
    with trace.span("engine.step"):
        pass
    assert len(trace.spans()) == n


def test_an_await_begun_before_the_profiler_is_recorded():
    """A span that awaits keeps its start while off: one that outlasts the
    start of a profiler is recorded whole, one that ends after the
    profiler stopped is not."""
    async def main():
        with trace.span("pipeline.sketch", awaits=True, req_id=7) as sp:
            assert sp is None
            await asyncio.sleep(0.01)
            with profile(activities=[ProfilerActivity.CPU]):
                await asyncio.sleep(0.01)
                with trace.span("pipeline.answer", awaits=True):
                    pass
        with trace.span("pipeline.expand", awaits=True):
            with profile(activities=[ProfilerActivity.CPU]):
                pass
    asyncio.run(main())
    done = trace.spans()
    assert [s.name for s in done] == ["pipeline.answer"]
    trace.clear()

    async def sketch():
        with trace.span("pipeline.sketch", awaits=True, req_id=7):
            await asyncio.sleep(0.02)
            trace.enable()
    asyncio.run(sketch())
    (s,) = trace.spans()
    assert (s.name, s.req_id, s.parent, s.awaits) == (
        "pipeline.sketch", 7, None, True)
    assert s.end - s.start >= 20e6


def test_ring_is_bounded():
    trace.enable()
    for _ in range(trace.RING + 3):
        with trace.span("x"):
            pass
    done = trace.spans()
    assert len(done) == trace.RING
    assert done[0].id == done[-1].id - trace.RING + 1


def test_export_chrome_is_on_the_profiler_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("engine.step", {"engine": "cloud"}):
            with record_function("block"):
                torch.ones(8).sum()
        sp = trace.begin("frontend.queued")
        trace.end(sp)
    path = tmp_path / "host.json"
    assert trace.export_chrome(path) == 2
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert lanes[spans["engine.step"]["tid"]] == "engine cloud"
    assert lanes[spans["frontend.queued"]["tid"]] == "answer None"
    block = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "block"]
    assert len(block) == 1
    # microseconds on kineto's clock: the span opens just before the block
    lag_us = block[0].start_ns() / 1e3 - spans["engine.step"]["ts"]
    assert 0 <= lag_us < 1000, lag_us
    assert spans["engine.step"]["dur"] >= block[0].duration_ns() / 1e3
