"""The benchmark's files against each other and against what they may
import: BENCHMARK.json's cells, configurations, mixes and readers exist
by name; nothing imports JAX or the JAX package, and the reference imports
nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pice_bench.tests import tiny

BENCH = tiny.ROOT / "pice_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = {_top(m) for m in _imports(f)} & FORBIDDEN
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tops = {_top(m) for m in _imports(f)}
        assert tops <= {"__future__", "math", "typing", "torch",
                        "pice_bench", "numpy"}, f
        assert not any(m.startswith(("pice_bench.harness",
                                     "pice_bench.metrics"))
                       for m in _imports(f))


def test_forbidden_modules_compare_whole_top_level_names():
    from pice_bench import harness
    held = ["torch", "repro_torch.serving.engine", "jaxtyping", "flaxen",
            "pice_bench.reference.common"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core.progressive",
                                             "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "repro"]


def test_benchmark_names_resolve():
    b = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    assert b["paths"] == ["pice_bench"]
    assert b["command"] == ["python3", "pice_bench/run.py"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        conf = json.loads((tiny.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        for m in conf["models"].values():
            assert (BENCH / "reference" / f"{m['model']['family']}.py"
                    ).exists()
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    from pice_bench import harness
    for n in names:
        assert harness.reader_path(n).parent == BENCH / "metrics", n
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", [w])
    assert max(m["bound"] for m in b["end_to_end"]) <= 0.25


def test_suffixed_metrics_share_a_reader_and_unknown_names_raise():
    from pice_bench import harness
    assert harness.reader_path("mfu.rag") == BENCH / "metrics" / "mfu.py"
    assert harness.reader_path("mfu.closed") == BENCH / "metrics" / "mfu.py"
    assert harness.reader_path("step_ms.cloud.rag").name == "step_ms.cloud.py"
    assert harness.reader_path("cloud_ttft_p95_ms.rag").name == \
        "cloud_ttft_p95_ms.rag.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path("no_such_metric.rag")


CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("config", CONFIGS)
def test_configuration_is_the_program_config_it_states(config):
    from repro_torch.configs.registry import get_config
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    for m in conf["models"].values():
        cfg = get_config(m["registry"]).with_(**m["model"])
        for k, v in m["model"].items():
            assert getattr(cfg, k) == v


@pytest.mark.parametrize("config", CONFIGS)
def test_frozen_latency_schedules_the_mixes(config):
    """At low load (an empty queue and pool) every request of the
    progressive mix goes progressive with the frozen latency models, and
    every request of the long-prompt mix is a cloud-full answer."""
    from pice_bench.traffic import generator
    from repro_torch.core import sketch
    from repro_torch.core.profiler import LatencyModel
    from repro_torch.core.progressive import PICEConfig
    from repro_torch.core.scheduler import DynamicScheduler, EdgeModelInfo
    from repro_torch.serving.network import NetworkModel
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cm, em = conf["models"]["cloud"], conf["models"]["edge"]
    sched = DynamicScheduler(
        LatencyModel(**cm["latency"]),
        [EdgeModelInfo(em["name"], LatencyModel(**em["latency"]),
                       em["capability"])], NetworkModel(), 1)
    short = PICEConfig().short_answer_tokens
    for mix, mode in (("progressive", "progressive"),
                      ("cloud-rag", "cloud_full")):
        s = generator.Stream(generator.load(mix), 7)
        for _ in range(200):
            it = s.next()
            l_i = min(sketch.heuristic_expected_length(it.query,
                                                       it.category),
                      it.max_new_tokens)
            got = "cloud_full" if l_i <= short else sched.schedule(l_i).mode
            assert got == mode, (mix, l_i)


def test_run_refuses_without_a_card_and_prints_nothing():
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "pice-dense.progressive", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tiny.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
