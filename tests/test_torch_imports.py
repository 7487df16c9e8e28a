"""The PyTorch port stands alone: every module of src/repro_torch imports
with JAX made unimportable, and no file of the port (nor chip_smoke.py)
imports jax or the JAX package `repro`."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


ANALYSIS = sorted((PORT / "analysis").glob("*.py"))


@pytest.mark.parametrize("path", ANALYSIS, ids=lambda p: p.name)
def test_analysis_is_stdlib_only(path):
    """The static checkers parse source and never import what they check:
    the standard library and their own package only."""
    bad = [m for m in _imported(path)
           if m.split(".")[0] not in sys.stdlib_module_names
           and not m.startswith("repro_torch.analysis")]
    assert not bad, f"{path.name} imports {bad}"


def test_analysis_cli_runs_without_torch(tmp_path):
    code = ("import sys\n"
            "for m in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            f"sys.exit(main(['--strict', '--report', {str(tmp_path / 'r.json')!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 violation(s)" in out.stdout
