"""The readers of the program's own spans (`program_spans.py`,
`idle_share.*`, `sketch_p95_ms.closed`, `admit_wait_p95_ms.closed`): on a
made-up trace and made-up spans, against a program without a tracer, and
on traced tiny runs, where the engine's per-step rows must equal what the
harness derives from outside."""
import sys
import types

import pytest

from pice_bench import harness, program_spans, tracing
from pice_bench.tests import tiny
from pice_bench.yardstick import quantile
from repro_torch import trace

from pice_bench.tests.test_pice_bench_arith import _ctx


def _span(name, a, b, awaits=False):
    """A finished span from a to b seconds on the host clock."""
    return types.SimpleNamespace(name=name, start=int(a * 1e9),
                                 end=int(b * 1e9), awaits=awaits, attrs={})


# the window (10, 20) ends its 1 s traced sub-window: it opens at 19.0
KERNELS = [("gemm", 0.0, 0.2), ("decode_kernel", 0.5, 0.1),
           ("gemm", 0.9, 0.1)]
SPANS = [_span("frontend.tick", 19.05, 19.46),
         _span("engine.step", 19.1, 19.45),
         _span("engine.readback", 19.15, 19.25),
         _span("engine.decode", 19.3, 19.4),
         _span("engine.prefix", 19.7, 19.8),
         _span("pipeline.sketch", 9.0, 10.5, awaits=True),
         _span("pipeline.sketch", 12.0, 14.0, awaits=True),
         _span("pipeline.sketch", 19.5, 21.0, awaits=True),
         _span("frontend.queued", 10.1, 10.15, awaits=True),
         _span("frontend.queued", 11.0, 11.01, awaits=True)]


@pytest.fixture
def made_up(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    t = tracing.Trace(window_s=1.0, busy_s=0.4, kernels=KERNELS, gaps=[],
                      calls=[])
    return _ctx([], trace=t)


def test_span_readers_on_a_made_up_trace(made_up):
    # idle 0.2-0.5: readback .05, step's own .05, decode .1, step's own
    # .05, tick .01, nothing .04; idle 0.6-0.9: nothing .1, prefix .1,
    # nothing .1; the sketches' awaits cover everything and count for none
    got = {k: harness.read_metric(f"idle_share.{k}.closed", made_up)
           for k in program_spans.KINDS}
    assert got == pytest.approx({"plan": 15.0, "launch": 20.0,
                                 "serve": 25.0})
    assert harness.read_metric("idle_share.plan.rag", made_up) == \
        pytest.approx(15.0)
    assert sum(got.values()) == pytest.approx(
        harness.read_metric("device_idle_share.closed", made_up))
    # sketches that ended in the window: 1.5 s and 2 s
    assert harness.read_metric("sketch_p95_ms.closed", made_up) == \
        pytest.approx(quantile([1500.0, 2000.0], 0.95))
    assert harness.read_metric("admit_wait_p95_ms.closed", made_up) == \
        pytest.approx(quantile([50.0, 10.0], 0.95))
    # no device trace: the idle readers find nothing to read
    bare = _ctx([])
    assert harness.read_metric("idle_share.serve.closed", bare) is None


def test_an_idle_interval_is_split_in_proportion():
    host = [(0.0, 10.0, "frontend.tick"), (1.0, 4.0, "engine.step"),
            (2.0, 3.0, "engine.ingest"), (6.0, 9.0, "engine.admit")]
    got = program_spans.attribute([(1.5, 2.5), (5.0, 7.0)], host)
    assert got == pytest.approx({"plan": 1.5, "launch": 0.5,
                                 "serve": 1.0})
    # the same intervals, idle everywhere: the three kinds tile the span
    whole = program_spans.attribute([(0.0, 12.0)], host)
    assert whole == pytest.approx({"plan": 5.0, "launch": 1.0,
                                   "serve": 6.0})
    # intervals that overlap once placed on the host's clock each count
    both = program_spans.attribute([(1.5, 2.5), (2.0, 3.5)], host)
    assert both == pytest.approx({"plan": 1.0, "launch": 1.5,
                                  "serve": 0.0})


def test_device_clock_drift_is_followed_through_readbacks(monkeypatch):
    """The trace's device clock agrees with the host's for 0.55 s (as on
    the card), then falls behind by 2 ms a second; each readback ends 40-44
    us after its copy on the host's clock. Idle time is placed on the
    host's clock before it is attributed."""
    def behind(x):
        return 0.002 * max(x - 0.55, 0.0)
    copies = [("Memcpy DtoH (Device -> Pageable)", 0.1 * i - 2e-6, 2e-6)
              for i in range(1, 10)]
    reads = [_span("engine.readback", 19.0 + 0.1 * i + behind(0.1 * i) - 1e-4,
                   19.0 + 0.1 * i + behind(0.1 * i) + 4e-5 + 2e-6 * (i % 3))
             for i in range(1, 10)]
    # the device idles from 0.95 on its clock to the end, from 0.9507 on
    # the host's (the shift held past the last readback, at 0.9); the host
    # launches a decode from 0.9505 to 0.953
    kernels = copies + [("gemm", 0.0, 0.95)]
    spans = reads + [_span("engine.decode", 19.9505, 19.953)]
    monkeypatch.setattr(trace, "spans", lambda: spans)
    ctx = _ctx([], trace=tracing.Trace(window_s=1.0, busy_s=0.95,
                                       kernels=kernels, gaps=[], calls=[]))
    knots = program_spans.clock_shift(ctx, spans)
    assert [c for c, _ in knots] == pytest.approx([0.1 * i for i in
                                                   range(1, 10)])
    assert [d for _, d in knots] == pytest.approx(
        [behind(0.1 * i) for i in range(1, 10)], abs=3e-6)
    got = program_spans.idle_by_kind(ctx)
    assert got["launch"] == pytest.approx(0.953 - 0.95 - behind(0.9),
                                          abs=3e-6)
    # the idle time keeps its length on the trace's clock
    assert sum(got.values()) == pytest.approx(0.05, abs=3e-6)


def test_a_program_without_a_tracer_reads_nothing(made_up, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    for name in ("idle_share.plan.closed", "idle_share.launch.rag",
                 "idle_share.serve.closed", "sketch_p95_ms.closed",
                 "admit_wait_p95_ms.closed"):
        assert harness.read_metric(name, made_up) is None, name
    # the accepted device readers are unchanged
    assert harness.read_metric("device_idle_share.closed", made_up) == 60.0


def _traced(kind):
    """A traced tiny run's context and the program spans of its traced
    sub-window; the harness's recorder is kept."""
    conf, mix, name = tiny.CELLS[kind]
    cell = {"name": name, "config": conf, "traffic": mix, "chips": 1}
    config = tiny.load(conf)
    import time
    run = harness.Run(cell, config, tiny.load(mix), 2_300_000_017, 6.0, True,
                      "cpu", time.perf_counter(), limits={})
    trace.clear()
    ctx = run.measure(harness.Fleet(config, run.traffic, run.seed, "cpu"))
    names = {e.name: role for role, e in run.fleet.engines.items()}
    return ctx, trace.spans(), names


@pytest.fixture(scope="module", params=["dense", "rag"])
def traced(request):
    return _traced(request.param)


def test_step_rows_equal_the_harness_calls(traced):
    ctx, done, names = traced
    calls = []
    for s in done:
        role = names.get(s.attrs.get("engine"))
        if s.name == "engine.step" and role:
            if s.attrs.get("decode"):
                calls.append((role, "decode",
                              [(c, 1) for c in s.attrs["decode"]]))
            if s.attrs.get("ingest"):
                calls.append((role, "ingest", sorted(s.attrs["ingest"])))
        elif s.name == "engine.prefix" and role:
            calls.append((role, "prefix", list(s.attrs["chunks"])))
    want = [(role, kind, sorted(rows) if kind == "ingest" else rows)
            for role, kind, rows in ctx.trace.calls]
    assert calls == want
    assert {kind for _, kind, _ in want} >= {"decode", "ingest"}
    # one program step span a harness step span in the sub-window
    lo, hi = ctx.window[1] - ctx.trace.window_s, ctx.window[1]
    for role in set(names.values()):
        theirs = [1 for a, b in ctx.spans.get(f"{role}.step", ())
                  if a >= lo and b <= hi]
        ours = [1 for s in done if s.name == "engine.step"
                and names[s.attrs["engine"]] == role]
        assert len(ours) == len(theirs), role
    # the CPU has no device trace: only the span readers of the cell read
    if ctx.traffic["loop"] == "closed":
        assert harness.read_metric("admit_wait_p95_ms.closed", ctx) >= 0
    assert harness.read_metric("idle_share.plan.closed", ctx) is None
