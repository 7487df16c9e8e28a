"""Pass 6 — async-blocking (RA601-RA602).

The serving front-end and load generator are cooperative asyncio code: ONE
driver coroutine interleaves engine steps with request intake/streaming, so
a single blocking call in these modules stalls every in-flight stream at
once — there is no other thread to make progress.

  RA601  `time.sleep` in the async serving layer (use `await
         asyncio.sleep`; a bare `sleep` imported from time counts too,
         an awaited `sleep(...)` does not).
  RA602  a torch device sync — `torch.cuda.synchronize()`, an Event's or
         Stream's `.synchronize()`, `.item()`, `.cpu()`, `.tolist()` of a
         tensor or `.to("cpu")` — in an async path. The engine's
         step/harvest entry points are the only sanctioned device
         boundary; the front-end must consume tokens the engine has
         already committed to host, never force its own sync.

Purely syntactic like the other passes: it proves the presence of known
blocking patterns in the scoped files, not their absence elsewhere.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import rules
from repro_torch.analysis.common import (SourceFile, Violation, apply_waivers,
                                   dotted, load_files, parent_map)


_SYNC_METHODS = ("synchronize", "item", "cpu")


def _is_sync(node: ast.Call, d: str) -> bool:
    """A torch device sync (see RA602). `.tolist()` counts on a torch
    expression only: the front-end's numpy arrays have one too."""
    if d == "torch.cuda.synchronize":
        return True
    if not isinstance(node.func, ast.Attribute):
        return False
    attr = node.func.attr
    if attr in _SYNC_METHODS and not node.args:
        return True
    if attr == "tolist":
        return dotted(node.func.value).startswith("torch.") or any(
            isinstance(n, ast.Call) and dotted(n.func).startswith("torch.")
            for n in ast.walk(node.func.value))
    return attr == "to" and any(
        isinstance(a, ast.Constant) and a.value == "cpu"
        for a in list(node.args) + [kw.value for kw in node.keywords])


def check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    parents = parent_map(sf.tree)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d == "time.sleep" or (
                d == "sleep" and not isinstance(parents.get(node),
                                                ast.Await)):
            out.append(Violation(
                file=sf.rel, line=node.lineno, code="RA601",
                message="blocking sleep stalls every in-flight stream on "
                        "the event loop (use `await asyncio.sleep`)"))
        elif _is_sync(node, d):
            out.append(Violation(
                file=sf.rel, line=node.lineno, code="RA602",
                message=f"`{d}` forces a device sync in an async serving "
                        "path (the engine step/harvest is the only "
                        "sanctioned device boundary)"))
    return apply_waivers(sf, out)


def run(root) -> List[Violation]:
    out: List[Violation] = []
    for sf in load_files(root, rules.ASYNC_SCOPE):
        out.extend(check_file(sf))
    return out
