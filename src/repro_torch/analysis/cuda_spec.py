"""Pass 4 — CUDA launch contracts on sm_90 (RA404-RA406; the JAX package's
Pallas block-spec pass, recast for the hand-written kernels of `csrc/`).

A launch that asks for more dynamic shared memory than the kernel allows,
or a cluster larger than the card takes by default, fails only at run time,
and only on the shapes that reach it. This pass re-derives the contracts
from the CUDA C++ source without compiling it:

  RA404  a compile-time shared-memory size above the 227 KB
         (`SMEM_MAX_BYTES`) a block may hold on sm_90: a kernel's static
         `__shared__` arrays summed, a literal (or constant) dynamic size at
         a launch, or a `constexpr` shared-memory constant (a name with
         "smem" in it);
  RA405  a launch (`kernel<<<grid, block, smem, ...>>>`, or
         `cudaLaunchKernelEx` with `cfg.dynamicSmemBytes = smem`) whose
         dynamic shared memory can exceed the default 48 KB
         (`SMEM_DEFAULT_BYTES`: a size not known at compile time, or a
         known one above it) with no `cudaFuncSetAttribute(...,
         cudaFuncAttributeMaxDynamicSharedMemorySize, ...)` before it in
         the same host function, directly or through a helper of the same
         file that the function calls first;
  RA406  a literal thread-block cluster dim (`clusterDim.x = N`,
         `__cluster_dims__(...)`) above 8 (`MAX_PORTABLE_CLUSTER`) without
         `cudaFuncAttributeNonPortableClusterSizeAllowed` in the function
         (or the file, for `__cluster_dims__`).

Constants resolve through `constexpr` definitions and `#define`s of the
file and the shared headers (`csrc/*.cuh`), with `sizeof` of the scalar
and vector types the kernels use; a size that does not resolve is not
known at compile time. Like the other passes it is syntactic: it finds
the presence of these patterns, not their absence.

The JAX package's RA401-RA403 (index-map arity, block-spec rank, sublane
alignment) have no counterpart (`rules.XLA_ONLY`); the registers,
spills and static shared memory nvcc reports are printed and held to the
sm_90 limits where the kernels are built (`chip_smoke.py`).
"""
from __future__ import annotations

import ast
import operator
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import rules
from repro_torch.analysis.common import Violation

_SIZEOF = {"char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1, "half": 2,
           "__half": 2, "__nv_bfloat16": 2, "bf16": 2, "int16_t": 2,
           "uint16_t": 2, "float": 4, "int": 4, "unsigned": 4, "uint32_t": 4,
           "int32_t": 4, "float2": 8, "double": 8, "int64_t": 8,
           "uint64_t": 8, "size_t": 8, "float4": 16, "int4": 16,
           "uint4": 16}
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Div: operator.floordiv,
        ast.Mod: operator.mod, ast.LShift: operator.lshift,
        ast.RShift: operator.rshift}


# ---------------------------------------------------------------------------
# source plumbing
# ---------------------------------------------------------------------------

def _blank(src: str) -> str:
    """Comments and string literals replaced by spaces (newlines kept), so
    offsets and line numbers stay the source's."""
    out = list(src)
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            j += 1
        else:
            i += 1
            continue
        for k in range(i, min(j, n)):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


class CudaFile:
    """One CUDA source: its text with comments and strings blanked, its
    brace blocks, and its pragma table."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = str(path.relative_to(root))
        self.source = path.read_text()
        self.text = _blank(self.source)
        self.pragmas = rules.parse_pragmas(self.source)
        self.blocks = self._blocks()

    def _blocks(self) -> List[Tuple[int, int, str]]:
        """(open, close, header) of every brace block; the header is the
        text between the previous ';', '{' or '}' and the '{', without
        preprocessor lines."""
        stack, out = [], []
        for i, c in enumerate(self.text):
            if c == "{":
                stack.append(i)
            elif c == "}" and stack:
                start = stack.pop()
                j = max(self.text.rfind(ch, 0, start) for ch in ";{}")
                header = re.sub(r"^\s*#.*$", "", self.text[j + 1:start],
                                flags=re.M)
                out.append((start, i, header.strip()))
        return out

    def line(self, offset: int) -> int:
        return self.text.count("\n", 0, offset) + 1

    def function_at(self, offset: int) -> Optional[Tuple[int, int, str]]:
        """The outermost enclosing block that is not a namespace, an
        `extern "C"` block, a struct or a class: the function body."""
        best = None
        for start, end, header in self.blocks:
            if start < offset < end and not re.match(
                    r"(namespace|extern|struct|class|union|enum)\b", header):
                if best is None or start < best[0]:
                    best = (start, end, header)
        return best

    def function_name(self, header: str) -> str:
        m = re.search(r"([A-Za-z_]\w*)\s*\([^()]*(?:\([^()]*\)[^()]*)*\)"
                      r"[^()]*$", header)
        return m.group(1) if m else ""


def _constants(files: List[CudaFile]) -> Dict[str, int]:
    """constexpr / #define integer constants, resolved to a fixpoint."""
    defs: Dict[str, str] = {}
    for f in files:
        for m in re.finditer(
                r"constexpr\s+(?:static\s+)?[\w:]+\s+(\w+)\s*=\s*([^;{]+);",
                f.text):
            defs.setdefault(m.group(1), m.group(2))
        for m in re.finditer(r"^\s*#define\s+(\w+)\s+([^\n]+)$", f.text,
                             re.M):
            defs.setdefault(m.group(1), m.group(2))
    values: Dict[str, int] = {}
    for _ in range(len(defs) + 1):
        changed = False
        for name, expr in defs.items():
            if name not in values:
                v = evaluate(expr, values)
                if v is not None:
                    values[name] = v
                    changed = True
        if not changed:
            break
    return values


def evaluate(expr: str, consts: Dict[str, int]) -> Optional[int]:
    """An integer C expression of literals, known constants and sizeof,
    or None."""
    e = re.sub(r"sizeof\s*\(\s*([\w:]+)\s*\)",
               lambda m: str(_SIZEOF.get(m.group(1).split("::")[-1], "X")),
               expr)
    e = re.sub(r"\(\s*(?:size_t|int|unsigned|long|uint32_t)\s*\)", "", e)
    e = re.sub(r"\b\w+::", "", e)                   # namespace qualifiers
    e = re.sub(r"\b(\d+)(?:[uU]?[lL]{0,2}|[lL]{1,2}[uU]?)\b", r"\1", e)
    e = e.replace("/", "//").replace("////", "//")
    try:
        tree = ast.parse(e.strip(), mode="eval")
    except SyntaxError:
        return None

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name) and n.id in consts:
            return consts[n.id]
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            a, b = ev(n.left), ev(n.right)
            if a is None or b is None or (b == 0 and isinstance(
                    n.op, (ast.FloorDiv, ast.Div, ast.Mod))):
                return None
            return _OPS[type(n.op)](a, b)
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            v = ev(n.operand)
            return None if v is None else -v
        return None
    return ev(tree)


def _split_args(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    out.append("".join(cur))
    return [a.strip() for a in out]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _opted_in(f: CudaFile, fn, offset: int, attr: str) -> bool:
    """`attr` appears in the function before `offset`, or in the body of a
    same-file function that it calls before `offset`."""
    body = f.text[fn[0]:offset]
    if attr in body:
        return True
    for start, end, header in f.blocks:
        name = f.function_name(header)
        if name and attr in f.text[start:end] \
                and re.search(rf"\b{name}\s*\(", body):
            return True
    return False


def _launches(f: CudaFile):
    """(offset, dynamic smem expression or None) of each launch."""
    for m in re.finditer(r"<<<(.*?)>>>", f.text, re.S):
        args = _split_args(m.group(1))
        yield m.start(), (args[2] if len(args) > 2 else "0")
    for m in re.finditer(r"cudaLaunchKernelEx\s*\(", f.text):
        fn = f.function_at(m.start())
        if fn is None:
            continue
        sets = re.findall(r"\.dynamicSmemBytes\s*=\s*([^;]+);",
                          f.text[fn[0]:m.start()])
        yield m.start(), (sets[-1] if sets else "0")


def check_file(f: CudaFile, consts: Dict[str, int]) -> List[Violation]:
    out: List[Violation] = []

    def report(offset, code, msg):
        out.append(Violation(file=f.rel, line=f.line(offset), code=code,
                             message=msg))

    # RA404 / RA405 at each launch
    for offset, expr in _launches(f):
        size = evaluate(expr, consts)
        if size is not None and size > rules.SMEM_MAX_BYTES:
            report(offset, "RA404",
                   f"the launch asks for {size} B of dynamic shared memory, "
                   f"past the {rules.SMEM_MAX_BYTES} B a block may hold")
        if size is not None and size <= rules.SMEM_DEFAULT_BYTES:
            continue
        fn = f.function_at(offset)
        if fn is None or not _opted_in(
                f, fn, offset, "cudaFuncAttributeMaxDynamicSharedMemorySize"):
            what = f"{size} B" if size is not None else f"`{expr}` (not " \
                "known at compile time)"
            report(offset, "RA405",
                   f"dynamic shared memory {what} can exceed "
                   f"{rules.SMEM_DEFAULT_BYTES} B with no "
                   "cudaFuncAttributeMaxDynamicSharedMemorySize opt-in "
                   "before the launch")

    # RA404: shared-memory constants
    for m in re.finditer(r"constexpr\s+[\w:]+\s+(\w*[Ss]mem\w*)\s*=\s*"
                         r"([^;{]+);", f.text):
        size = consts.get(m.group(1), evaluate(m.group(2), consts))
        if size is not None and size > rules.SMEM_MAX_BYTES:
            report(m.start(), "RA404",
                   f"`{m.group(1)}` = {size} B of shared memory, past the "
                   f"{rules.SMEM_MAX_BYTES} B a block may hold")

    # RA404: a kernel's static __shared__ arrays
    static: Dict[Tuple[int, int, str], int] = {}
    for m in re.finditer(r"(?<!extern )__shared__\s+(?:__align__\(\d+\)\s+)?"
                         r"([\w:]+)\s+\w+((?:\s*\[[^\]]+\])+)\s*;", f.text):
        fn = f.function_at(m.start())
        item = _SIZEOF.get(m.group(1).split("::")[-1])
        if fn is None or item is None:
            continue
        n = item
        for dim in re.findall(r"\[([^\]]+)\]", m.group(2)):
            v = evaluate(dim, consts)
            n = None if (n is None or v is None) else n * v
        if n is not None:
            static[fn] = static.get(fn, 0) + n
    for fn, n in static.items():
        if n > rules.SMEM_MAX_BYTES:
            report(fn[0], "RA404",
                   f"`{f.function_name(fn[2])}` declares {n} B of static "
                   f"shared memory, past the {rules.SMEM_MAX_BYTES} B a "
                   f"block may hold")

    # RA406: literal cluster dims past the portable 8
    portable = "cudaFuncAttributeNonPortableClusterSizeAllowed"
    for m in re.finditer(r"clusterDim\.[xyz]\s*=\s*(\d+)\s*;", f.text):
        fn = f.function_at(m.start())
        if int(m.group(1)) > rules.MAX_PORTABLE_CLUSTER and (
                fn is None or not _opted_in(f, fn, fn[1], portable)):
            report(m.start(), "RA406",
                   f"cluster dim {m.group(1)} past the portable "
                   f"{rules.MAX_PORTABLE_CLUSTER} without {portable}")
    for m in re.finditer(r"__cluster_dims__\s*\(([^)]*)\)", f.text):
        dims = [evaluate(a, consts) for a in _split_args(m.group(1))]
        total = 1
        for d in dims:
            total *= d or 1
        if total > rules.MAX_PORTABLE_CLUSTER and portable not in f.text:
            report(m.start(), "RA406",
                   f"__cluster_dims__ of {total} blocks past the portable "
                   f"{rules.MAX_PORTABLE_CLUSTER} without {portable}")

    for v in out:
        entry = f.pragmas.get(v.line)
        if entry and v.code in entry[0]:
            v.waived, v.waive_reason = True, entry[1]
    return out


def run(root: Path) -> List[Violation]:
    files = [CudaFile(p, root) for glob in rules.CUDA_SCOPE_GLOBS
             for p in sorted(root.glob(glob))]
    consts = _constants([f for f in files if f.rel.endswith(".cuh")])
    out: List[Violation] = []
    for f in files:
        local = dict(consts)
        local.update(_constants([f]))
        out.extend(check_file(f, local))
    return out
