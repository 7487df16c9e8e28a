"""Pass 5 — swallowed exceptions in the fault-handling paths (RA501).

The fault model (docs/serving.md) requires every caught fault to be
OBSERVABLE: an `except` clause in the serving/core trees must either
re-raise, or record the event somewhere telemetry can see it — a
RuntimeMonitor / injector call (`monitor.*`, `record_*`, `on_*`, `log*`),
or a counter bump on a fault/telemetry attribute (`*.cancels += 1`,
`self.stats[...] = ...`). A handler that does neither silently converts a
fault into wrong behavior the chaos benchmarks cannot attribute.

Like the other passes this is deliberately syntactic: it proves the
*presence* of a recording pattern in the handler body, not that the value
recorded is meaningful.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import rules
from repro_torch.analysis.common import (SourceFile, Violation, apply_waivers,
                                   dotted, load_files)

# dotted-name segments that mark a call as "recording" the fault
_RECORDING_SEGMENTS = {"monitor", "logger", "logging", "warnings"}
_RECORDING_PREFIXES = ("record", "on_", "log", "warn", "abort", "fault",
                       "note")
# attribute/subscript name segments that count as telemetry counters when
# assigned/augmented inside a handler
_COUNTER_SEGMENTS = ("fault", "shed", "retr", "cancel", "fail", "event",
                     "loss", "stat", "error", "count", "degraded", "crash")


def _call_records(call: ast.Call) -> bool:
    d = dotted(call.func)
    if not d:
        return False
    parts = d.split(".")
    if any(p in _RECORDING_SEGMENTS for p in parts):
        return True
    return any(parts[-1].startswith(p) for p in _RECORDING_PREFIXES)


def _target_is_counter(node: ast.AST) -> bool:
    """`self.cancels`, `monitor.net_failures`, `self.stats["x"]`, ..."""
    if isinstance(node, ast.Subscript):
        node = node.value
    d = dotted(node).lower()
    return any(seg in d for seg in _COUNTER_SEGMENTS)


def _handler_observes(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and _call_records(node):
            return True
        if isinstance(node, ast.AugAssign) and _target_is_counter(node.target):
            return True
        if isinstance(node, ast.Assign) and any(
                _target_is_counter(t) for t in node.targets):
            return True
    return False


def check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _handler_observes(node):
            continue
        caught = dotted(node.type) if node.type is not None else "BaseException"
        out.append(Violation(
            file=sf.rel, line=node.lineno, code="RA501",
            message=rules.RULES["RA501"] + f" (catches {caught or 'tuple'})"))
    return apply_waivers(sf, out)


def run(root) -> List[Violation]:
    out: List[Violation] = []
    for sf in load_files(root, rules.EXCEPTIONS_SCOPE):
        out.extend(check_file(sf))
    return out
