"""Pass 3 — captured buffers (RA301; the JAX package's donation safety,
recast for CUDA graphs).

A captured CUDA graph holds raw pointers to every tensor it reads or
writes: the engine's cache leaves, its params and its static graph inputs
(`rules.CAPTURED_BUFFERS`). After capture they must be updated in place;
rebinding one of them to other storage leaves the graph reading and
writing the old storage. `engine._check_captured` catches it at run time
(the data pointers against the capture's); this pass catches the rebinding
in the source:

  RA301  in a class that captures graphs, an assignment to
         `self.<buffer>` outside `__init__` and the capture functions,
         unless its value is a call that is given `self.<buffer>` itself
         (the port's entry points update the cache in place and return
         it: `logits, self.cache = transformer.decode_step(..., self.cache,
         ...)` rebinds the name to the same storage).

The JAX package's RA302 (a donated buffer read after the call that
consumed it) has no counterpart: torch has no donation (`rules.XLA_ONLY`).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import rules
from repro_torch.analysis.common import (SourceFile, Violation, apply_waivers,
                                         dotted, load_files)

_CAPTURE_CALLS = ("torch.cuda.CUDAGraph", "torch.cuda.graph")


def _captures(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func) in _CAPTURE_CALLS
               for n in ast.walk(node))


def _targets(stmt: ast.stmt):
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    else:
        return []
    out = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                    and n.value.id == "self" \
                    and n.attr in rules.CAPTURED_BUFFERS:
                out.append(n.attr)
    return out


def _passes_itself(value: ast.AST, attr: str) -> bool:
    """`value` is a call given `self.<attr>` (an in-place update that
    returns the same tensors)."""
    return isinstance(value, ast.Call) and any(
        isinstance(n, ast.Attribute) and dotted(n) == f"self.{attr}"
        for a in list(value.args) + [kw.value for kw in value.keywords]
        for n in ast.walk(a))


def check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef) or not _captures(cls):
            continue
        for m in cls.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or m.name == "__init__" or _captures(m):
                continue
            for stmt in ast.walk(m):
                if not isinstance(stmt, ast.stmt):
                    continue
                value = getattr(stmt, "value", None)
                for attr in _targets(stmt):
                    if value is not None and _passes_itself(value, attr):
                        continue
                    out.append(Violation(
                        file=sf.rel, line=stmt.lineno, code="RA301",
                        message=f"`self.{attr}` is rebound in `{m.name}`: a "
                                "captured graph keeps reading its old "
                                "storage (update it in place)"))
    return apply_waivers(sf, out)


def run(root) -> List[Violation]:
    out: List[Violation] = []
    for sf in load_files(root, rules.CAPTURE_SCOPE):
        out.extend(check_file(sf))
    return out
