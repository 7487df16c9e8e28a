"""Pass 2 — graph-capture buckets (RA201-RA205; the JAX package's recompile
budget, recast for CUDA graphs).

The JAX engine bounds its jit shape variants; the port compiles nothing
per shape, but a warmed paged engine captures its decode-and-sample step
as one CUDA graph per live width (`engine._capture_decode`), a chunked one
also its batched ragged ingest per row bucket (`engine._capture_ingest`),
and each graph holds its own memory and costs a capture. The contract is
that the set of graphs is bounded and captured in `warmup()`:

  RA201  a call to a power-of-two bucket helper that does not clamp (the
         helper itself returns `min(...)`, or the call site wraps it in
         `min(...)`): one long request would add an unbounded variant.
  RA202  `torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)` or
         `torch.cuda.make_graphed_callables(...)` outside the engine's
         capture site (`rules.GRAPH_CAPTURE_SITES`).
  RA203  a graph keyed on a value that is visibly request-derived (it
         contains `len(...)` or a per-request attribute) or a local name
         with no bucketed provenance: the first argument of a `_capture*`
         call, or the key of a lookup or store in a `*graphs` dict
         outside the capture functions.
  RA205  a capture function that `warmup()` does not reach through
         `self.` calls (or a class that captures and has no warmup()):
         its first capture would land inside a serving window.

The JAX package's RA204 (an lru_cache'd jit registry) has no counterpart
(`rules.XLA_ONLY`).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis import rules
from repro_torch.analysis.common import (SourceFile, Violation, apply_waivers,
                                         dotted, enclosing_function,
                                         load_files, parent_map)

_CAPTURE_CALLS = ("torch.cuda.CUDAGraph", "torch.cuda.graph",
                  "torch.cuda.make_graphed_callables")
_CAPTURE_PREFIX = "_capture"
_REQUEST_ATTRS = {"ctx_len", "prompt", "tokens", "prefill_toks", "pending",
                  "suffix", "carry_tokens"}


def _helper_name(call: ast.Call) -> Optional[str]:
    last = dotted(call.func).split(".")[-1]
    return last if last in rules.BUCKET_HELPERS else None


def _self_clamping_helpers(tree: ast.AST) -> Set[str]:
    """Bucket helpers whose own return value is clamped (contains min(...)
    or delegates to another self-clamping helper)."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)
            and n.name in rules.BUCKET_HELPERS}
    clamped: Set[str] = set()
    for _ in range(len(defs) + 1):          # fixpoint over delegation chains
        for name, fn in defs.items():
            if name in clamped:
                continue
            for ret in ast.walk(fn):
                if not isinstance(ret, ast.Return) or ret.value is None:
                    continue
                for c in ast.walk(ret.value):
                    if isinstance(c, ast.Call) and (
                            dotted(c.func) == "min"
                            or _helper_name(c) in clamped):
                        clamped.add(name)
    return clamped


def _wrapped_in_min(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> bool:
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, ast.stmt):
        if isinstance(cur, ast.Call) and dotted(cur.func) == "min":
            return True
        cur = parents.get(cur)
    return False


def _bucketed_names(fn: ast.FunctionDef) -> Set[str]:
    """Local names with bucketed provenance inside `fn`: assigned from a
    bucket-helper call, doubled in a pow2 while loop, looped over a bucketed
    collection, or a collection accumulating bucketed values."""
    bucketed: Set[str] = set()

    def expr_bucketed(e: ast.AST) -> bool:
        for n in ast.walk(e):
            if isinstance(n, ast.Call) and _helper_name(n):
                return True
            if isinstance(n, ast.Name) and n.id in bucketed:
                return True
        return False

    for _ in range(3):                       # small fixpoint
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and expr_bucketed(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bucketed.add(t.id)
            elif isinstance(node, ast.While):
                for sub in ast.walk(node):   # `while r < n: r *= 2`
                    if (isinstance(sub, ast.AugAssign)
                            and isinstance(sub.op, ast.Mult)
                            and isinstance(sub.target, ast.Name)):
                        bucketed.add(sub.target.id)
            elif isinstance(node, ast.For) and expr_bucketed(node.iter):
                if isinstance(node.target, ast.Name):
                    bucketed.add(node.target.id)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("add", "append")
                  and isinstance(node.func.value, ast.Name)
                  and node.args and expr_bucketed(node.args[0])):
                bucketed.add(node.func.value.id)
    return bucketed


def _key_problem(arg: ast.AST, bucketed: Set[str]) -> Optional[str]:
    """None if a graph key is acceptable, else the reason."""
    for n in ast.walk(arg):
        if isinstance(n, ast.Call) and _helper_name(n):
            return None
        if isinstance(n, ast.Call) and dotted(n.func) == "len":
            return "contains len(...) of request data"
        if isinstance(n, ast.Attribute) and n.attr in _REQUEST_ATTRS:
            return f"derived from per-request `.{n.attr}`"
    if isinstance(arg, ast.Name) and arg.id not in bucketed:
        return f"`{arg.id}` has no bucketed provenance in this function"
    return None                  # a constant or a config / plan attribute


def _is_graph_dict(node: ast.AST) -> bool:
    return dotted(node).split(".")[-1].endswith("graphs")


def _graph_keys(node: ast.AST):
    """(key expr) of a `*graphs` lookup or store: `g.get(k)`, `g[k]`."""
    if isinstance(node, ast.Subscript) and _is_graph_dict(node.value):
        return node.slice
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("get", "pop", "setdefault") \
            and _is_graph_dict(node.func.value) and node.args:
        return node.args[0]
    return None


def _self_calls(fn: ast.AST) -> Set[str]:
    return {n.func.attr for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"}


def _captures(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func) in _CAPTURE_CALLS
               for n in ast.walk(fn))


def check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    parents = parent_map(sf.tree)
    clamped = _self_clamping_helpers(sf.tree)

    # RA205: every capture method must be reached from warmup()
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        reached: Set[str] = set()
        todo = ["warmup"] if "warmup" in methods else []
        while todo:
            name = todo.pop()
            if name in reached or name not in methods:
                continue
            reached.add(name)
            todo.extend(_self_calls(methods[name]))
        for name, m in methods.items():
            if _captures(m) and name not in reached:
                why = ("warmup() does not reach it" if "warmup" in methods
                       else "the class defines no warmup()")
                out.append(Violation(
                    file=sf.rel, line=m.lineno, code="RA205",
                    message=f"`{name}` captures a CUDA graph but {why}: its "
                            "first capture lands inside a serving window"))

    for node in ast.walk(sf.tree):
        fn = enclosing_function(node, parents)
        # RA203: graph keys in lookups and stores outside the capture code
        key = _graph_keys(node)
        if key is not None and not (fn is not None
                                    and fn.name.startswith(_CAPTURE_PREFIX)):
            why = _key_problem(key, _bucketed_names(fn) if fn else set())
            if why:
                out.append(Violation(
                    file=sf.rel, line=node.lineno, code="RA203",
                    message=f"graph key is not visibly bucketed: {why}"))
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        # RA202: graph captures only at the engine's capture site
        if d in _CAPTURE_CALLS and not any(
                sf.rel.endswith(path) and fn is not None and fn.name == name
                for path, name in rules.GRAPH_CAPTURE_SITES):
            out.append(Violation(
                file=sf.rel, line=node.lineno, code="RA202",
                message=f"`{d}` outside the engine's capture site: a graph "
                        "captured here is not bounded by its live widths"))
        # RA201: unclamped bucket
        helper = _helper_name(node)
        if helper and helper not in clamped \
                and not _wrapped_in_min(node, parents) \
                and (fn is None or fn.name != helper):
            out.append(Violation(
                file=sf.rel, line=node.lineno, code="RA201",
                message=f"`{helper}(...)` used without an upper clamp: one "
                        "long request adds an unbounded graph variant "
                        "(wrap in min(..., max_len))"))
        # RA203: the key a capture call is given
        last = d.split(".")[-1]
        if last.startswith(_CAPTURE_PREFIX) \
                and isinstance(node.func, ast.Attribute) and node.args:
            why = _key_problem(node.args[0],
                               _bucketed_names(fn) if fn else set())
            if why:
                out.append(Violation(
                    file=sf.rel, line=node.lineno, code="RA203",
                    message=f"the graph key of `{last}` is not visibly "
                            f"bucketed: {why}"))
    return apply_waivers(sf, out)


def run(root) -> List[Violation]:
    out: List[Violation] = []
    for sf in load_files(root, rules.RECOMPILE_SCOPE):
        out.extend(check_file(sf))
    return out
