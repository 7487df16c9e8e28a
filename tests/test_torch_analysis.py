"""The port's static checkers (`repro_torch.analysis`).

Bad fixtures under tests/fixtures/torch_analysis/bad/ carry `# expect:
CODE[,CODE]` (`// expect:` in CUDA) markers on the exact line each
violation must be reported at; each pass must report exactly that
(file, line, code) set. The good tree and the live src/repro_torch tree
must be clean under --strict, every waiver with a reason. The two passes
that carry over unchanged (RA501, RA601) must give the JAX package's
findings on the JAX package's own fixtures."""
import json
import re
from pathlib import Path

import pytest

from repro import analysis as ref_analysis
from repro.analysis import rules as ref_rules
from repro_torch.analysis import PASSES, package_root, run_all, rules
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.common import SourceFile
from repro_torch.analysis.rules import parse_pragmas

FIXTURES = Path(__file__).parent / "fixtures" / "torch_analysis"
BAD = FIXTURES / "bad"
GOOD = FIXTURES / "good"
REF_BAD = Path(__file__).parent / "fixtures" / "analysis" / "bad"

_EXPECT_RE = re.compile(r"(?:#|//)\s*expect:\s*([A-Z0-9,]+)")


def _expected(root: Path, code_prefix: str):
    out = set()
    for p in sorted(root.rglob("*")):
        if p.suffix not in (".py", ".cu", ".cuh"):
            continue
        rel = str(p.relative_to(root))
        for i, line in enumerate(p.read_text().splitlines(), 1):
            m = _EXPECT_RE.search(line)
            if not m:
                continue
            for code in m.group(1).split(","):
                if code.startswith(code_prefix):
                    out.add((rel, i, code))
    return out


@pytest.mark.parametrize("pass_name,prefix", [
    ("host-sync", "RA1"),
    ("recompile", "RA2"),
    ("donation", "RA3"),
    ("cuda-spec", "RA4"),
    ("exceptions", "RA5"),
    ("async-blocking", "RA6"),
])
def test_bad_fixtures_exact_codes_and_lines(pass_name, prefix):
    found = {(v.file, v.line, v.code)
             for v in PASSES[pass_name](BAD) if not v.waived}
    want = _expected(BAD, prefix)
    assert want, f"no markers for {prefix}"
    assert found == want, (
        f"{pass_name}: reported violations do not match fixture markers")


def test_bad_fixture_waiver_is_counted_not_reported():
    waived = [v for v in PASSES["host-sync"](BAD) if v.waived]
    assert len(waived) == 1
    assert waived[0].code == "RA101"
    assert "waiver" in waived[0].waive_reason


def test_good_fixtures_are_clean():
    violations = run_all(GOOD)
    unwaived = [v for v in violations if not v.waived]
    assert unwaived == [], [v.render() for v in unwaived]
    waived = [v for v in violations if v.waived]
    assert {v.code for v in waived} == {"RA103", "RA405", "RA501"}
    assert all(v.waive_reason for v in waived)


def test_live_tree_passes_strict(tmp_path):
    report = tmp_path / "analysis_report.json"
    rc = analysis_main(["--strict", "--report", str(report)])
    assert rc == 0, "src/repro_torch must stay clean under --strict"
    data = json.loads(report.read_text())
    assert data["ok"] and data["root"] == str(package_root())
    assert data["counts"]["active"] == 0
    assert data["counts"]["waived_without_reason"] == 0
    # every waiver the port needs, by file and code
    waived = sorted((v["file"], v["code"]) for v in data["violations"])
    assert waived == sorted([
        ("csrc/flash_decode.cuh", "RA405"), ("csrc/rmsnorm.cu", "RA405"),
        ("finetune/reward_model.py", "RA103"),
        ("finetune/rlaif.py", "RA103"), ("finetune/rlaif.py", "RA103"),
        ("serving/engine.py", "RA103"), ("serving/engine.py", "RA103"),
        ("serving/engine.py", "RA104"), ("serving/engine.py", "RA201"),
        ("serving/frontend.py", "RA501"),
        ("training/train_loop.py", "RA103")])


def test_strict_cli_fails_on_bad_fixtures(tmp_path):
    rc = analysis_main(["--strict", "--root", str(BAD),
                        "--report", str(tmp_path / "r.json")])
    assert rc == 1
    rc = analysis_main(["--strict", "--root", str(GOOD), "--report", "-"])
    assert rc == 0


def test_reasonless_waiver_fails_strict(tmp_path):
    root = tmp_path / "pkg"
    (root / "serving").mkdir(parents=True)
    (root / "serving" / "x.py").write_text(
        "import torch\n\n\ndef f(x):\n    y = torch.exp(x)\n"
        "    return y.item()  # repro-analysis: disable=RA101\n")
    assert analysis_main(["--root", str(root), "--report", "-"]) == 0
    assert analysis_main(["--strict", "--root", str(root),
                          "--report", "-"]) == 1


def test_pragma_parsing():
    src = (
        "x = 1\n"
        "y = float(z)  # repro-analysis: disable=RA101 reason=because\n"
        "# repro-analysis: disable=RA102,RA103\n"
        "q = np.asarray(z)\n"
        "  // repro-analysis: disable=RA405 reason=opted in by the caller\n"
        "  k<<<1, 32, smem>>>();\n"
    )
    pragmas = parse_pragmas(src)
    assert pragmas[2] == ({"RA101"}, "because")
    assert pragmas[4] == ({"RA102", "RA103"}, None)
    assert pragmas[6] == ({"RA405"}, "opted in by the caller")


def test_engine_harvest_is_the_only_unwaived_read():
    assert rules.HOST_SYNC_ALLOWLIST == {("serving/engine.py", "_harvest")}
    assert rules.GRAPH_CAPTURE_SITES == {("serving/engine.py",
                                          "_capture_decode"),
                                         ("serving/engine.py",
                                          "_capture_ingest")}
    engine = package_root() / "serving" / "engine.py"
    sf = SourceFile.load(engine, package_root())
    from repro_torch.analysis import host_sync
    found = host_sync.check_file(sf)
    assert [v.render() for v in found if not v.waived] == []
    harvest = [v for v in found if "_harvest" in v.message]
    assert harvest == []                  # the allowlisted read
    # RA104: the ingest replay's wait on its staging block's last copy
    assert {v.code for v in found} == {"RA103", "RA104"}
    assert any("_first_draws" in v.message for v in found)


@pytest.mark.parametrize("pass_name,code", [("exceptions", "RA501"),
                                            ("async-blocking", "RA601")])
def test_carried_passes_match_reference_on_its_fixtures(pass_name, code):
    got = {(v.file, v.line, v.waived) for v in PASSES[pass_name](REF_BAD)
           if v.code == code}
    want = {(v.file, v.line, v.waived)
            for v in ref_analysis.PASSES[pass_name](REF_BAD)
            if v.code == code}
    assert got == want and want


def test_every_reference_code_is_recast_or_xla_only():
    ref_codes = set(ref_rules.RULES)
    assert set(rules.RULES) | set(rules.XLA_ONLY) >= ref_codes
    assert not set(rules.RULES) & set(rules.XLA_ONLY)
    assert set(rules.XLA_ONLY) == {"RA204", "RA302", "RA401", "RA402",
                                   "RA403"}
    for code in rules.RULES:
        assert code in ref_codes or code in ("RA405", "RA406"), code
    assert rules.SMEM_MAX_BYTES == 232448 and rules.MAX_REGISTERS == 255


def test_cuda_constants_resolve():
    from repro_torch.analysis.cuda_spec import evaluate
    consts = {"kTile": 64, "kRows": 16}
    assert evaluate("3 * kTile + 3 * kRows + 4", consts) == 244
    assert evaluate("(3 * kTile) * sizeof(float)", consts) == 768
    assert evaluate("ns::kTile / 8", consts) == 8
    assert evaluate("sizeof(float4) * 2u", consts) == 32
    assert evaluate("smem", consts) is None


def test_ptxas_resource_report_parses(monkeypatch, tmp_path):
    """`kernels.runtime.resource_usage` reads each entry function's
    registers, spills and static shared memory from ptxas's report (the
    build half of RA4xx, which chip_smoke.py holds to the sm_90 limits)."""
    from repro_torch.kernels import runtime
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z3fooPf' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    36 bytes stack frame, 36 bytes spill stores, 40 bytes "
           "spill loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers, 16 bytes "
           "smem, 400 bytes cmem[0]\n"
           "ptxas info    : Function properties for _Z6helperv\n"
           "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info    : Compiling entry function '_Z3barPf' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z3barPf\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 32 registers, 400 bytes cmem[0]\n")
    monkeypatch.setattr(runtime, "BUILD", tmp_path)
    (tmp_path / "libk.ptxas.log").write_text(log)
    assert runtime.resource_usage(["k", "unbuilt"]) == [
        {"source": "k", "function": "_Z3fooPf", "registers": 255,
         "spill_stores": 36, "spill_loads": 40, "smem": 16},
        {"source": "k", "function": "_Z3barPf", "registers": 32,
         "spill_stores": 0, "spill_loads": 0, "smem": 0}]
