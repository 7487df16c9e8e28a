"""Pass 1 — host syncs in the serving hot paths (RA101-RA104).

Enforces the engine's one-readback-per-step contract: the ONLY unannotated
device->host read lives in the engine's deferred harvest (`_harvest`);
every other sync is a violation unless waived with a pragma:

  RA101  `.item()`, or float()/int()/bool() of a device tensor;
  RA102  np.asarray / np.array / `.numpy()` of a device tensor;
  RA103  `.cpu()` or `.to("cpu")` anywhere, `.tolist()` of a device
         tensor, outside the harvest;
  RA104  `torch.cuda.synchronize()`, or an Event's / a Stream's
         `.synchronize()`.

A lightweight per-function taint analysis: names assigned from
device-producing calls (`torch.*`, the model entry points, the sampler,
the engine's device helpers, `.to(...)` / `.cuda()`) are device tensors;
subscripts, attribute loads and arithmetic carry the taint; the result of a
read (`.cpu()`, `.numpy()`, `.tolist()`, `.item()`) is a host value and
clears it. Deliberately syntactic: it proves the presence of known sync
patterns, not their absence.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis import rules
from repro_torch.analysis.common import (SourceFile, Violation, apply_waivers,
                                         dotted, load_files)

_SCALAR_CASTS = {"float", "int", "bool"}
_NP_TRANSFER = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# torch calls whose result lies on the host (or is not a tensor)
_HOST_TORCH = {"torch.from_numpy", "torch.no_grad", "torch.inference_mode",
               "torch.device", "torch.Generator", "torch.enable_grad",
               "torch.is_grad_enabled", "torch.get_default_dtype"}
# module prefixes of the port's device-producing entry points
_DEVICE_MODULES = ("torch.", "transformer.", "attn_lib.", "moe_lib.",
                   "ssm_lib.", "xlstm_lib.", "pc.", "cache_lib.")
# method-name prefixes on `self.` / locals that return device tensors
_DEVICE_METHOD_PREFIXES = ("_decode_run", "_decode_sample", "_prefill",
                           "_score", "_fork", "_insert", "_feed_chunk",
                           "_ingest_chunk", "_to_device", "_replay_decode")
_DEVICE_FN_NAMES = {"sample", "token_logprob", "gumbel_noise", "to", "cuda"}
_READS = {"cpu", "numpy", "tolist", "item"}     # results are host values
_METADATA = {"shape", "dtype", "device", "ndim", "is_cuda"}


def _is_cpu_move(call: ast.Call) -> bool:
    """`x.to("cpu")`, `x.to(device="cpu")` or `x.to(torch.device("cpu"))`."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Call) and dotted(v.func) == "torch.device":
            v = v.args[0] if v.args else v
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
    return False


class _FnChecker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, fn: ast.FunctionDef,
                 allowlisted: bool):
        self.sf = sf
        self.fn = fn
        self.allowlisted = allowlisted
        self.taint: Set[str] = set()
        self.violations: List[Violation] = []

    # -- taint machinery -------------------------------------------------
    def _producer_call(self, call: ast.Call) -> bool:
        d = dotted(call.func)
        if not d:
            return False
        last = d.split(".")[-1]
        if last in _READS or _is_cpu_move(call):
            return False                      # a read: the result is host
        if d in _HOST_TORCH or d.startswith("torch.cuda."):
            return False
        if d.startswith(_DEVICE_MODULES):
            return True
        if last in _DEVICE_FN_NAMES:
            return True
        return any(last.startswith(p) for p in _DEVICE_METHOD_PREFIXES)

    def _tainted(self, node) -> bool:
        """Whether `node` evaluates to a device tensor: a name or attribute
        the function tainted, a producer call, a method call or a non-
        metadata attribute of a device tensor, or an expression over one.
        A call's arguments do not taint its result, and a read's result
        (and its rows) are host values."""
        if node is None:
            return False
        if isinstance(node, ast.Subscript):
            return self._tainted(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and (
                    node.func.attr in _READS or _is_cpu_move(node)):
                return False
            if self._producer_call(node):
                return True
            return isinstance(node.func, ast.Attribute) \
                and self._tainted(node.func.value)
        if isinstance(node, (ast.Name, ast.Attribute)):
            if dotted(node) in self.taint:
                return True
            return isinstance(node, ast.Attribute) \
                and node.attr not in _METADATA \
                and self._tainted(node.value)
        if isinstance(node, (ast.Lambda, ast.comprehension)):
            return False
        return any(self._tainted(c) for c in ast.iter_child_nodes(node))

    def _mark(self, target: ast.AST, on: bool):
        """Taint (or clear) an assignment target: each name of a tuple, the
        container of a subscript store (only ever tainted), the dotted
        name itself (not its base: `engine.params = ...` leaves `engine`
        alone)."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e, on)
        elif isinstance(target, ast.Starred):
            self._mark(target.value, on)
        elif isinstance(target, ast.Subscript):
            if on:
                self._mark(target.value, True)
        else:
            d = dotted(target)
            if d:
                (self.taint.add if on else self.taint.discard)(d)

    # -- sinks -----------------------------------------------------------
    def _report(self, node: ast.AST, code: str, msg: str):
        self.violations.append(Violation(
            file=self.sf.rel, line=node.lineno, code=code, message=msg))

    def visit_Call(self, node: ast.Call):
        d = dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        base = node.func.value if attr else None
        if attr == "cpu" or _is_cpu_move(node) or (
                attr == "tolist" and self._tainted(base)):
            if not self.allowlisted:
                self._report(node, "RA103",
                             f"`.{attr}()` reads the device outside the "
                             f"sanctioned harvest site (in `{self.fn.name}`)")
        elif d in _SCALAR_CASTS and node.args \
                and self._tainted(node.args[0]):
            self._report(node, "RA101",
                         f"`{d}()` on a device tensor forces a host sync")
        elif attr == "item" and self._tainted(base):
            self._report(node, "RA101",
                         "`.item()` on a device tensor forces a host sync")
        elif (d in _NP_TRANSFER and node.args
              and self._tainted(node.args[0])) or (
                attr == "numpy" and self._tainted(base)):
            self._report(node, "RA102",
                         f"`{d}` on a device tensor forces a transfer")
        elif d == "torch.cuda.synchronize" or (
                attr == "synchronize" and d != "torch.cuda.synchronize"):
            self._report(node, "RA104",
                         f"`{d}()` stalls the host until the device drains")
        self.generic_visit(node)

    # -- statement-order taint updates ----------------------------------
    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        on = self._tainted(node.value)
        for t in node.targets:
            self._mark(t, on)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.visit(node.value)
        if self._tainted(node.value):
            self._mark(node.target, True)

    def visit_For(self, node: ast.For):
        self.visit(node.iter)
        if self._tainted(node.iter):
            self._mark(node.target, True)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def _visit_comp(self, node):
        for gen in node.generators:
            self.visit(gen.iter)
            if self._tainted(gen.iter):
                self._mark(gen.target, True)
        for field in ("elt", "key", "value"):
            sub = getattr(node, field, None)
            if sub is not None:
                self.visit(sub)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if node is not self.fn:
            return                             # nested defs: checked separately
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef


def check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        allow = any(sf.rel.endswith(path) and node.name == fn
                    for path, fn in rules.HOST_SYNC_ALLOWLIST)
        checker = _FnChecker(sf, node, allow)
        checker.visit_FunctionDef(node)
        out.extend(checker.violations)
    return apply_waivers(sf, out)


def run(root) -> List[Violation]:
    out: List[Violation] = []
    for sf in load_files(root, rules.HOST_SYNC_SCOPE):
        out.extend(check_file(sf))
    return out
