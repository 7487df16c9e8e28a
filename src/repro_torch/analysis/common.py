"""Shared plumbing for the static passes: violations, file walking, waivers.

Everything here is stdlib-only (ast + pathlib): the passes parse source, they
never import the modules they check, so the CLI runs in environments without
torch and on fixture files that are deliberately broken.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis import rules


@dataclasses.dataclass
class Violation:
    file: str                   # path as reported (relative to package root)
    line: int
    code: str
    message: str
    waived: bool = False
    waive_reason: Optional[str] = None

    def render(self) -> str:
        tag = " (waived: %s)" % (self.waive_reason or "no reason given") \
            if self.waived else ""
        return f"{self.file}:{self.line}: {self.code} {self.message}{tag}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SourceFile:
    """One parsed file plus its pragma table."""
    path: Path                  # absolute
    rel: str                    # path relative to the scanned root
    source: str
    tree: ast.AST
    pragmas: Dict[int, Tuple[set, Optional[str]]]

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        src = path.read_text()
        return cls(path=path, rel=str(path.relative_to(root)), source=src,
                   tree=ast.parse(src, filename=str(path)),
                   pragmas=rules.parse_pragmas(src))


def load_files(root: Path, suffixes: Iterable[str]) -> List[SourceFile]:
    """Files under `root` whose root-relative path starts with (or equals)
    one of `suffixes` (directory prefixes end with '/')."""
    out = []
    for p in sorted(root.rglob("*.py")):
        rel = str(p.relative_to(root))
        for s in suffixes:
            if rel == s or (s.endswith("/") and rel.startswith(s)):
                out.append(SourceFile.load(p, root))
                break
    return out


def apply_waivers(sf: SourceFile, violations: List[Violation]
                  ) -> List[Violation]:
    """Mark violations matched by an inline pragma as waived."""
    for v in violations:
        entry = sf.pragmas.get(v.line)
        if entry and v.code in entry[0]:
            v.waived = True
            v.waive_reason = entry[1]
    return violations


def dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    return {child: parent for parent in ast.walk(tree)
            for child in ast.iter_child_nodes(parent)}


def enclosing_function(node: ast.AST, parents: Dict[ast.AST, ast.AST]
                       ) -> Optional[ast.FunctionDef]:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None
