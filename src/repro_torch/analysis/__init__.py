"""Static invariant checkers for the port's serving engine and CUDA kernels
(the JAX package's `repro.analysis`, recast for PyTorch and CUDA).

Six passes over `src/repro_torch` (codes are the JAX package's):

  host_sync       RA1xx  one readback a step: no .item() / .cpu() /
                         .tolist() / synchronize() outside the harvest
  recompile       RA2xx  bounded, warmed CUDA-graph variants (live-width
                         buckets, one capture site, warmup() reaches it)
  donation        RA3xx  tensors a captured graph holds are updated in
                         place, never rebound
  cuda_spec       RA4xx  sm_90 launch contracts over csrc/*.cu: dynamic
                         shared memory past 48 KB opted in, clusters past 8
                         opted in, nothing past 227 KB
  exceptions      RA5xx  caught faults must be re-raised or recorded
  async_blocking  RA6xx  no blocking sleep or device sync on the serving
                         event loop

The JAX package's codes with no counterpart here, each with its reason,
are in `rules.XLA_ONLY`: RA204 (an lru_cache'd jit registry), RA302 (a
donated buffer read after its call), RA401 / RA402 (Pallas index-map and
block-spec ranks) and RA403 (TPU sublane alignment).

Run `python -m repro_torch.analysis --strict`. Everything in this package
is stdlib-only: the passes parse source (Python with `ast`, CUDA C++ with a
small scanner) and never import the modules they check.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

from repro_torch.analysis import (async_blocking, cuda_spec, donation,
                                  exceptions, host_sync, recompile, rules)
from repro_torch.analysis.common import SourceFile, Violation

PASSES = {
    "host-sync": host_sync.run,
    "recompile": recompile.run,
    "donation": donation.run,
    "cuda-spec": cuda_spec.run,
    "exceptions": exceptions.run,
    "async-blocking": async_blocking.run,
}


def package_root() -> Path:
    """The `repro_torch` package directory that pass scopes are relative
    to."""
    return Path(__file__).resolve().parents[1]


def run_all(root: Path = None, passes=None) -> List[Violation]:
    root = root or package_root()
    out: List[Violation] = []
    for name in (passes or PASSES):
        out.extend(PASSES[name](root))
    out.sort(key=lambda v: (v.file, v.line, v.code))
    return out


__all__ = ["PASSES", "run_all", "package_root", "Violation", "SourceFile",
           "rules"]
