"""Shared constants and rule registry for the `repro_torch.analysis`
checkers.

Stdlib-only: the passes parse source (Python with `ast`, CUDA C++ with a
small scanner) and never import what they check, so the CLI runs without
torch and on fixture files that are deliberately broken.
"""
from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# Hopper (sm_90) limits the CUDA pass and chip_smoke.py's build report hold
# the kernels to.
# ---------------------------------------------------------------------------
# dynamic shared memory a launch gets without cudaFuncSetAttribute(...,
# cudaFuncAttributeMaxDynamicSharedMemorySize, ...)
SMEM_DEFAULT_BYTES = 48 * 1024
# the most shared memory one block may hold on sm_90 (227 KB)
SMEM_MAX_BYTES = 227 * 1024
# thread-block cluster sizes past this need
# cudaFuncAttributeNonPortableClusterSizeAllowed
MAX_PORTABLE_CLUSTER = 8
# registers a thread may hold
MAX_REGISTERS = 255

# ---------------------------------------------------------------------------
# Rule registry. Codes are the JAX package's, recast for PyTorch and CUDA;
# the codes of XLA-only rules are listed in XLA_ONLY with the reason.
# ---------------------------------------------------------------------------
RULES = {
    # host-sync / trace-safety
    "RA101": "implicit host sync: float()/int()/bool()/.item() on a device "
             "tensor in a serving hot path",
    "RA102": "np.asarray/np.array/.numpy() on a device tensor forces a "
             "transfer in a serving hot path",
    "RA103": ".cpu()/.tolist()/.to('cpu') outside the sanctioned per-step "
             "harvest site",
    "RA104": "torch.cuda.synchronize() or an Event/Stream .synchronize() in "
             "a serving hot path",
    # graph-capture buckets
    "RA201": "power-of-two bucket used as a shape without an upper clamp "
             "(captures O(requests) graph variants)",
    "RA202": "CUDA graph capture (torch.cuda.CUDAGraph / torch.cuda.graph) "
             "outside the engine's capture site",
    "RA203": "graph keyed on a raw request-derived value instead of a "
             "bucketing helper",
    "RA205": "captured graph variant never reached from warmup() (its first "
             "capture lands inside a serving window)",
    # captured buffers
    "RA301": "a tensor a captured graph holds is rebound by assignment after "
             "capture instead of being updated in place",
    # CUDA launch contracts (sm_90)
    "RA404": "a compile-time shared-memory size above the 227 KB a block may "
             "hold on sm_90",
    "RA405": "a launch whose dynamic shared memory can exceed 48 KB with no "
             "cudaFuncAttributeMaxDynamicSharedMemorySize opt-in before it "
             "in the same host function",
    "RA406": "a literal thread-block cluster dim above 8 without "
             "cudaFuncAttributeNonPortableClusterSizeAllowed",
    # fault observability
    "RA501": "except clause swallows the exception without re-raising or "
             "recording it to a monitor/telemetry counter",
    # async-blocking (serving front-end event loop)
    "RA601": "blocking time.sleep in the async serving layer (stalls every "
             "in-flight stream; use `await asyncio.sleep`)",
    "RA602": "torch device sync (torch.cuda.synchronize, .synchronize(), "
             ".item(), .cpu(), .tolist(), .to('cpu')) in an async serving "
             "path",
}

# The JAX package's codes that have no counterpart, and why.
XLA_ONLY = {
    "RA204": "a jit registry must be lru_cache'd so engines share XLA's "
             "trace cache; the port compiles nothing per shape (its kernels "
             "build once a process, its graphs are an engine's own)",
    "RA302": "a donated buffer read after the call that consumed it; torch "
             "has no donation: a tensor stays valid after any call, and the "
             "hazard left, rebinding a captured tensor, is RA301",
    "RA401": "a Pallas index_map's arity against its grid rank; a CUDA "
             "kernel indexes with blockIdx itself",
    "RA402": "a Pallas BlockSpec's rank against its index_map's; CUDA has "
             "no block specs",
    "RA403": "a TPU VMEM tile's sublane alignment (multiples of 8); the "
             "CUDA kernels' alignment is checked at run time "
             "(`runtime.check_tensor`, `check_limits`)",
}

# ---------------------------------------------------------------------------
# Pass scopes: path prefixes relative to the repro_torch package root.
# ---------------------------------------------------------------------------
HOST_SYNC_SCOPE = (
    "serving/", "models/paged_cache.py", "models/transformer.py",
    "training/train_loop.py", "finetune/", "core/profiler.py",
)
RECOMPILE_SCOPE = ("serving/", "finetune/", "training/")
CAPTURE_SCOPE = ("serving/engine.py", "training/train_loop.py")
CUDA_SCOPE_GLOBS = ("csrc/*.cu", "csrc/*.cuh")
EXCEPTIONS_SCOPE = ("serving/", "core/")
ASYNC_SCOPE = ("serving/frontend.py", "serving/loadgen.py")

# The ONLY function allowed to read the device back without a pragma: the
# engine's deferred harvest (one device->host copy a step, the plan/run
# contract). Admission-time first-token draws, offline scoring and
# train-loop logging carry an inline waiver with a reason.
HOST_SYNC_ALLOWLIST = {("serving/engine.py", "_harvest")}
# The only function allowed to capture a CUDA graph.
GRAPH_CAPTURE_SITES = {("serving/engine.py", "_capture_decode")}

# Helpers whose results count as bucketed (a bounded set of graph keys).
BUCKET_HELPERS = ("_bucket", "_chunk_live", "_live_pages", "_pow2_bucket")
# Attribute names that are config-bounded (not request-derived).
BOUNDED_ATTR_NAMES = {
    "live", "max_batch", "max_len", "prefill_chunk", "pages_per_seq",
    "page_size", "n_pages", "seq_len", "max_sketch_tokens",
}
# Attributes of an engine that its captured graphs read by pointer.
CAPTURED_BUFFERS = ("cache", "params", "_graph_io")

# ---------------------------------------------------------------------------
# Inline waiver pragma, after the language's comment marker:
#     # repro-analysis: disable=RA101 reason=why          (Python)
#     // repro-analysis: disable=RA405 reason=why         (CUDA C++)
# (comma-separated codes; the reason is mandatory under --strict). The
# pragma waives matches on its own line or, when it is a whole-line
# comment, on the line directly below.
# ---------------------------------------------------------------------------
PRAGMA_RE = re.compile(
    r"(?:#|//)\s*repro-analysis:\s*disable=(?P<codes>[A-Z0-9,\s]+?)"
    r"(?:\s+reason=(?P<reason>.*))?$")


def parse_pragmas(source: str):
    """Map line number -> (set of rule codes, reason or None)."""
    out = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group("codes").split(",") if c.strip()}
        reason = m.group("reason")
        reason = reason.strip() if reason else None
        out[i] = (codes, reason)
        if line.lstrip().startswith(("#", "//")):
            out[i + 1] = (codes, reason)
    return out
