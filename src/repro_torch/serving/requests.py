"""Request/response types and SLA specs for the serving layer."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

_ids = itertools.count()


class BoundedRecord(dict):
    """Insertion-ordered mapping with a hard size cap: inserting a NEW key
    past `cap` evicts the oldest entries first (bounded-deque semantics over
    a dict API). This is the single bounding convention for per-request
    telemetry — the engine's `ttft`/`truncations`, the RuntimeMonitor's
    TTFT/latency windows, and the front-end's per-request records all use it,
    so none of them can grow without bound in a long-running fleet.

    `append(value)` supports window-style usage (samples keyed by an
    internal monotone counter); `percentile(q)` reads the kept window.
    """

    def __init__(self, cap: int = 4096):
        super().__init__()
        self.cap = max(int(cap), 1)
        self._seq = 0

    def __setitem__(self, key, value):
        if key not in self:
            while len(self) >= self.cap:
                super().pop(next(iter(self)))
        super().__setitem__(key, value)

    def append(self, value) -> None:
        """Record a sample in arrival order (window usage)."""
        self[("seq", self._seq)] = value
        self._seq += 1

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the kept values (0 when empty)."""
        vals = sorted(float(v) for v in self.values())
        if not vals:
            return 0.0
        idx = int(round(q / 100.0 * (len(vals) - 1)))
        return vals[min(max(idx, 0), len(vals) - 1)]


@dataclasses.dataclass(frozen=True)
class SLA:
    """Multi-criteria service-level agreement (paper §IV-A-1).

    `metric_order` ranks the soft objectives for the lexicographic
    formulation; `max_latency_s` is the hard constraint (Eq. 2 RHS uses the
    cloud-only latency when None).
    """
    max_latency_s: Optional[float] = None
    metric_order: tuple = ("error", "throughput", "latency",
                           "server_cost", "edge_cost")


# SLA tiers for the serving front-end / load generator: a tier names a hard
# latency budget measured FROM ARRIVAL (queue wait included) and an engine
# priority (higher = evicted last, admitted first). Budgets are relative
# units — the load generator scales them by the measured service time of the
# workload it replays (`sla_for_tier(tier, scale=...)`).
SLA_TIERS: Dict[str, Optional[float]] = {
    "interactive": 1.0,
    "standard": 4.0,
    "batch": None,                 # no hard deadline
}
TIER_PRIORITY: Dict[str, int] = {"interactive": 2, "standard": 1, "batch": 0}


def sla_for_tier(tier: str, scale: float = 1.0) -> SLA:
    """The SLA a tier implies, with its latency budget scaled by `scale`
    (seconds per budget unit — workload-calibrated by the load generator)."""
    budget = SLA_TIERS.get(tier)
    if budget is None:
        return SLA()
    return SLA(max_latency_s=budget * scale)


@dataclasses.dataclass
class Request:
    query: str
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    arrival_s: float = 0.0
    category: str = "generic"
    sla: SLA = dataclasses.field(default_factory=SLA)
    max_new_tokens: int = 512
    # wall-clock arrival stamp (time.perf_counter): when set, latency and
    # queue-wait accounting measure from ARRIVAL — queue wait included — not
    # from when a handler picked the request up. None preserves the
    # handler-relative accounting of callers that never queue.
    arrival_time_s: Optional[float] = None
    # SLA tier name (SLA_TIERS): maps to an engine priority and, through the
    # load generator, to an arrival-relative deadline
    tier: str = "standard"


@dataclasses.dataclass
class SketchTask:
    """An expansion task queued for the edge fleet (paper's job queue Q)."""
    req_id: int
    query: str
    sketch: str
    sentences: List[str]
    expected_length: int          # l_i — LLM-predicted response length
    sketch_tokens: int            # |r_i|
    created_s: float = 0.0


@dataclasses.dataclass
class Response:
    req_id: int
    text: str
    mode: str                     # "cloud_full" | "progressive"
    cloud_tokens: int = 0
    edge_tokens: int = 0
    latency_s: float = 0.0
    queue_wait_s: float = 0.0
    network_s: float = 0.0
    confidence: float = 0.0
    model_used: str = ""
    quality: Optional[float] = None
    # fault/degradation telemetry (PICE fault model, docs/serving.md):
    # `degraded` names the rung the request landed on — "" (none),
    # "ensemble_partial" (some members faulted, quorum-1 select),
    # "sketch_groups" (a group fell back to its sketch sentences),
    # "cloud_full_fallback" (edge path abandoned, cloud re-answered), or
    # "sketch_passthrough" (deadline blown: the sketch IS the answer)
    degraded: str = ""
    retries: int = 0              # network transfer retry attempts
    hedges: int = 0               # extra ensemble members launched
    deadline_s: float = 0.0       # per-request budget (0 = none)
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)
