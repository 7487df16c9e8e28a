"""Tiny cells end to end on the CPU: the result's shape, the reference's
verdict on a sound run, and the control read far above the limits."""
from pice_bench.tests import tiny


def _shape(out, kind):
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["device"]["platform"] == "cpu"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_dense_progressive_sound():
    out, run = tiny.run("dense")
    _shape(out, "dense")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"answers_per_s", "answer_p50_ms",
                                   "answer_p95_ms", "setup_s"}
    assert {"cloud.gap", "cloud.lp", "edge.gap", "edge.lp"} <= set(
        out["checks"])
    assert run.notes["truncated"] == 0


def test_rag_all_cloud_full_and_edge_bypassed():
    out, run = tiny.run("rag")
    _shape(out, "rag")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"cloud.gap", "cloud.lp"}
    assert "answers_per_s" not in out["metrics"]


def test_traced_per_layer_metrics():
    out, run = tiny.run("dense", trace=True)
    _shape(out, "dense")
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["progressive_share.closed"]["value"] == 100.0
    assert {"step_ms.cloud.closed", "step_ms.edge.closed"} <= set(m)
    # no device on the CPU: the device readers find nothing to read
    assert not {"mfu.closed", "device_idle_share.closed",
                "roofline.decode_attn.closed"} & set(m)
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out


def test_control_fails_the_limits():
    """The control (the reference with float8 operands) at the tiny size
    reads far above the sound program on every judged number."""
    out, run = tiny.run("dense", control=True)
    checks = run.readings
    for name in ("cloud.gap", "edge.gap"):
        assert checks[name + ".control"]["value"] > checks[name]["limit"]
        assert checks[name]["value"] <= checks[name]["limit"]
    # the same verdict that decides `correct` refuses the control
    assert out["correct"] and run.control_correct is False
