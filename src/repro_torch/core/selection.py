"""Edge-side online model selection (paper Algorithm 2).

When an edge device picks up task r_i it checks the remaining latency budget
f(l_i) - f(|r_i|): if the current SLM cannot finish in time it downgrades to
a smaller SLM; if there is slack AND the job queue is short it upgrades to a
higher-quality SLM (avoiding model-switch churn under load).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.profiler import LatencyModel
from repro_torch.core.scheduler import EdgeModelInfo


@dataclasses.dataclass
class SelectionResult:
    model: str
    action: str            # "keep" | "downgrade" | "upgrade"
    est_time_s: float


def select_model(current: str,
                 candidates: Sequence[EdgeModelInfo],
                 expected_len: int,
                 sketch_tokens: int,
                 cloud: LatencyModel,
                 queue_len: int,
                 queue_max: int,
                 parallelism: int = 1) -> SelectionResult:
    """Algorithm 2. candidates must be sorted by capability ascending."""
    by_name = {c.name: c for c in candidates}
    names = [c.name for c in candidates]
    cur = by_name[current]
    budget = cloud.f(expected_len) - cloud.f(sketch_tokens)   # f(l_i)-f(|r_i|)

    def est(m: EdgeModelInfo) -> float:
        return m.latency.f(expected_len / max(parallelism, 1))

    tau = est(cur)
    if tau > budget:                                   # Lines 3-4: downgrade
        idx = names.index(current)
        for j in range(idx - 1, -1, -1):
            m = by_name[names[j]]
            if est(m) <= budget:
                return SelectionResult(m.name, "downgrade", est(m))
        smallest = by_name[names[0]]
        return SelectionResult(smallest.name, "downgrade", est(smallest))
    # Lines 6-12: consider upgrading only when the queue is short
    if queue_len < queue_max:
        idx = names.index(current)
        for j in range(len(names) - 1, idx, -1):       # largest first
            m = by_name[names[j]]
            if est(m) <= budget:
                return SelectionResult(m.name, "upgrade", est(m))
    return SelectionResult(current, "keep", tau)
