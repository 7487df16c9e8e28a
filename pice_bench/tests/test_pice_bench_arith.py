"""The yardstick's arithmetic against hand-worked numbers, and the readers
on a made-up context."""
import statistics

import pytest

from pice_bench import harness, tracing, yardstick as y
from pice_bench.tests import tiny  # noqa: F401  (sys.path)

SPEC = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
        "dtype": "bfloat16", "kv_dtype": "", "ssm_expand": 2, "ssm_heads": 0,
        "ssm_state": 0, "shared_attn_every": 0}


def test_quantile_matches_linear_interpolation():
    v = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0]
    assert y.quantile(v, 0.5) == statistics.median(v)
    assert y.quantile(v, 0.95) == pytest.approx(8.75)
    assert y.quantile([], 0.5) is None


def test_counts_by_hand():
    # attention: wq 8x16, wk 8x8, wv 8x8, wo 16x8 = 384; mlp 3*8*16 = 384
    assert y.matmul_params(SPEC) == 2 * (384 + 384)
    assert y.unembed_params(SPEC) == 80
    # one query against 5 keys: 4 * hd 4 * Hq 4 * 5 keys * 2 layers
    assert y.attention_flops(SPEC, 5) == 640
    # K and V, 2 kv heads of 4, bf16, 2 layers
    assert y.kv_bytes_per_key(SPEC) == 64
    assert y.qo_bytes(SPEC) == 128
    # a decode row at offset 9 reads 10 keys
    assert y.decode_attention_bytes(SPEC, [9]) == 640 + 128
    # 3 new tokens at offset 2: keys 3 + 4 + 5 = 12
    assert y.step_flops(SPEC, [(2, 3)]) == 2 * 1536 * 3 + 128 * 12 + 160


def test_prefill_bound_takes_the_larger_term():
    rows = [(0, 512), (1024, 512)]
    flops = sum(y.attention_flops(SPEC, 1) * (n * o + n * (n + 1) // 2)
                for o, n in rows)
    nbytes = sum(64 * (o + n) + 128 * n for o, n in rows)
    assert y.prefill_attention_bound_s(SPEC, rows) == max(
        flops / 989e12, nbytes / 3.35e12)


def test_hybrid_counts():
    spec = dict(SPEC, family="hybrid", n_layers=6, shared_attn_every=3,
                ssm_state=4)
    inner = 16
    mamba = 8 * (2 * inner + 2 * 4 + 1) + inner * 8   # H = 16 // 64 -> 1
    assert y.attention_layers(spec) == 2
    assert y.matmul_params(spec) == 6 * mamba + 2 * 768


def _ctx(answers, window=(10.0, 20.0), trace=None, spans=None,
         loop="closed"):
    return harness.Context(
        cell={"name": "x"}, config={"models": {"cloud": {"model": SPEC},
                                               "edge": {"model": SPEC}}},
        traffic={"loop": loop}, window=window, answers=answers,
        spans=spans or {}, ttft={}, trace=trace, setup_s=3.5)


def _answer(i, due, done, ok=True, mode="progressive"):
    return harness.Answer(i, due, done, ok, mode)


def test_end_to_end_readers():
    a = [_answer(0, 1.0, 9.0), _answer(1, 9.5, 11.0), _answer(2, 11.0, 15.0),
         _answer(3, 12.0, 19.0, ok=False, mode="cloud_full"),
         _answer(4, 15.0, 21.0)]
    ctx = _ctx(a)
    assert harness.read_metric("answers_per_s", ctx) == pytest.approx(0.2)
    assert harness.read_metric("answer_p50_ms", ctx) == pytest.approx(2750.0)
    assert harness.read_metric("setup_s", ctx) == 3.5
    assert harness.read_metric("progressive_share.closed", ctx) == \
        pytest.approx(100 * 2 / 3)
    # open loop: due in the window, however late
    ctx = _ctx(a, loop="open")
    assert harness.read_metric("answer_p50_ms", ctx) == pytest.approx(5000.0)


def test_device_readers_on_a_made_up_trace():
    calls = [("cloud", "decode", [(99, 1), (199, 1)]),
             ("edge", "ingest", [(0, 4)])]
    kernels = [("void decode_kernel_mma<...>", 0.0, 1e-6),
               ("paged_prefill_kernel_mma", 0.1, 2e-6),
               ("sm90_gemm", 0.2, 0.3)]
    t = tracing.Trace(window_s=1.0, busy_s=0.25, kernels=kernels, gaps=[],
                      calls=calls)
    ctx = _ctx([], trace=t)
    need = y.decode_attention_bytes(SPEC, [99, 199])
    assert harness.read_metric("roofline.decode_attn.closed", ctx) == \
        pytest.approx(100 * need / 3.35e12 / 1e-6)
    assert harness.read_metric("device_idle_share.closed", ctx) == 75.0
    flops = y.step_flops(SPEC, [(99, 1), (199, 1)]) + y.step_flops(
        SPEC, [(0, 4)])
    assert harness.read_metric("mfu.closed", ctx) == pytest.approx(
        100 * flops / 989e12)
    bound = y.prefill_attention_bound_s(SPEC, [(0, 4)])
    assert harness.read_metric("roofline.prefill_attn.rag", ctx) == \
        pytest.approx(100 * bound / 2e-6)
    # nothing traced: the readers find nothing to read
    for name in ("roofline.decode_attn.closed", "mfu.rag",
                 "device_idle_share.rag"):
        assert harness.read_metric(name, _ctx([])) is None


def test_step_spans_in_the_window():
    spans = {"cloud.step": [(9.0, 9.5), (10.0, 10.004), (12.0, 12.006)],
             "edge.expand": [(11.0, 12.0), (13.0, 15.0)]}
    ctx = _ctx([], spans=spans)
    assert harness.read_metric("step_ms.cloud.closed", ctx) == \
        pytest.approx(5.0)
    assert harness.read_metric("expand_p95_ms.closed", ctx) == \
        pytest.approx(1950.0)


def test_sweep_window_stats_and_the_sustained_rule():
    from pice_bench import sweep

    def ans(due, lat):
        return harness.Answer(0, due, done=due + lat, ok=True)

    steady = [ans(9.0 + 0.5 * i, 1.0) for i in range(22)]
    st = sweep.window_stats(_ctx(steady, loop="open"), [0.01],
                            [(10.0, 15.0), (18.0, 22.0)])
    assert st["due_per_s"] == 2.0 and st["unanswered"] == 0
    assert st["backlog_mid"] == 2 and st["backlog_close"] == 1
    assert st["p95_first_half_ms"] == pytest.approx(1000.0)
    assert st["cloud_step_share"] == pytest.approx(0.7)
    assert st["sustained"]
    # latency that grows through the window: the backlog and the tail grow
    assert abs(st["backlog_per_s"]) < 0.05
    growing = [ans(10.0 + 0.5 * i, 0.1 * i * i) for i in range(20)]
    st = sweep.window_stats(_ctx(growing, loop="open"), [0.01], [])
    assert st["backlog_per_s"] > 0.1 * st["due_per_s"]
    assert not st["sustained"]
    assert sweep.slope([(0, 1.0), (1, 3.0), (2, 5.0)]) == 2.0
    late = sweep.window_stats(_ctx(steady, loop="open"), [1.5], [])
    assert not late["sustained"]


def test_sweep_needs_the_answers_to_keep_up():
    from pice_bench import sweep
    # every second request answered in the window: not sustained
    a = [harness.Answer(0, 10.0 + 0.5 * i, done=10.0 + 0.5 * i
                        + (1.0 if i % 2 else 20.0), ok=True)
         for i in range(20)]
    st = sweep.window_stats(_ctx(a, loop="open"), [0.0], [])
    assert st["answered_per_s"] < 0.97 * st["due_per_s"]
    assert not st["sustained"]
