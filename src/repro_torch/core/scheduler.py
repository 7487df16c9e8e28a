"""Dynamic scheduler (paper §IV-A): lexicographic multi-objective scheduling
with the Eq. (2) end-to-end latency hard constraint.

Cloud-side scheduling picks a sketch-length *level*:
    f(|r_i|) + Delta(r_i) + c*f(l_i) + sum_{r_j in Q} c*f(l_j)/(p*N) <= f(l_i)
choosing the shortest sketch the selected SLM can expand reliably; level 0
(no sketch that satisfies the constraint / capability floor) falls back to a
full cloud answer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.profiler import LatencyModel, RuntimeMonitor
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.requests import SLA

METRICS = ("error", "throughput", "latency", "server_cost", "edge_cost")


@dataclasses.dataclass
class EdgeModelInfo:
    name: str
    latency: LatencyModel          # f(l) of this SLM on its edge device
    capability: float              # quality proxy in (0,1)
    # minimum sketch compression this SLM can reliably expand: the sketch must
    # keep at least this fraction of the expected answer (more capable SLMs
    # tolerate shorter sketches — paper §IV-A-2)
    @property
    def min_sketch_ratio(self) -> float:
        return max(0.08, 0.55 - 0.5 * self.capability)


@dataclasses.dataclass
class ScheduleDecision:
    mode: str                      # "cloud_full" | "progressive"
    sketch_tokens: int = 0         # |r_i| target (level)
    level: int = 0
    edge_model: str = ""
    parallelism: int = 1
    est_latency_s: float = 0.0
    est_cloud_latency_s: float = 0.0
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


class DynamicScheduler:
    """Cloud-side level selection + metric bookkeeping."""

    def __init__(self, cloud: LatencyModel, edges: Sequence[EdgeModelInfo],
                 network: NetworkModel, n_edge_devices: int,
                 monitor: Optional[RuntimeMonitor] = None,
                 n_levels: int = 6, queue_max: int = 8):
        self.cloud = cloud
        self.edges = {e.name: e for e in edges}
        self.network = network
        self.n_edge = max(n_edge_devices, 1)
        self.monitor = monitor or RuntimeMonitor()
        self.n_levels = n_levels
        self.queue_max = queue_max

    # -- memory pressure ---------------------------------------------------
    def memory_pressure_factor(self) -> float:
        """Queueing-delay inflation from KV page-pool occupancy (M/M/1-style
        1/(1-rho)). At util 0 (dense backend / no telemetry) this is 1.0, so
        the seed behavior is unchanged; near exhaustion waits blow up and the
        scheduler backs off to shorter sketches / cloud_full.

        rho is the *physical* occupancy, so copy-on-write prefix sharing
        lowers the factor directly (an N-way fan-out pins one prefix, not N).
        The flip side: shared pages cannot be reclaimed by evicting a single
        fork, so when most of the used pool is shared the evictable headroom
        shrinks — rho is nudged toward the logical (unshared-equivalent)
        load in proportion to the shared fraction.

        rho uses the *predicted* occupancy when it exceeds the physical one:
        the length predictor's queued_expected_tokens, converted to pages
        (`kv_predicted_utilization`), anticipates the pool the queued work
        is about to pin, so Eq.(2) admission tightens BEFORE the pool
        actually fills instead of reacting to evictions after the fact.
        With an empty queue (or no page telemetry) the predicted value
        collapses to the physical one and the seed behavior is unchanged."""
        util = min(max(self.monitor.kv_utilization,
                       self.monitor.kv_predicted_utilization), 0.95)
        # non-reclaimable share of the occupancy: at shared_fraction 0 this
        # is plain physical rho; at 1.0 (eviction frees nothing) rho climbs
        # toward saturation by util/2 of the remaining headroom — the extra
        # util factor keeps the nudge negligible when the pool is near-empty
        rho = util + 0.5 * self.monitor.kv_shared_fraction * (0.95 - util) \
            * util
        rho = min(rho, 0.95)
        return 1.0 / (1.0 - rho)

    # forecast-occupancy ceiling for ADMISSION (not just pressure): above
    # it the progressive path is refused outright and the request answers
    # from the cloud — sketching work the pool cannot hold only converts
    # admission failures into mid-flight evictions
    admission_ceiling: float = 0.92

    def forecast_utilization(self, expected_len: int = 0) -> float:
        """Forecast KV occupancy if this request's expansion is admitted:
        max(physical, predicted-from-queue) utilization plus the pages the
        request's own expected output would pin. 0.0 without page telemetry
        (dense backend), so admission is inert there."""
        mon = self.monitor
        if mon.kv_pages_total <= 0:
            return 0.0
        util = max(mon.kv_utilization, mon.kv_predicted_utilization)
        if expected_len > 0 and mon.kv_page_tokens > 0:
            extra = math.ceil(expected_len / mon.kv_page_tokens)
            util += extra / mon.kv_pages_total
        return min(util, 1.0)

    def admit_progressive(self, expected_len: int) -> bool:
        """Eq.(2)'s memory leg as an ADMISSION decision: the progressive
        path is only open while the forecast occupancy — queued expected
        tokens included, so admission tightens as the backlog's predicted
        lengths grow — stays under `admission_ceiling`."""
        return self.forecast_utilization(expected_len) < \
            self.admission_ceiling

    # -- Eq. (2) -----------------------------------------------------------
    def e2e_latency(self, sketch_tokens: int, expected_len: int,
                    edge: EdgeModelInfo, parallelism: int) -> float:
        c_f_l = edge.latency.f(expected_len / max(parallelism, 1))
        wait = (self.monitor.queued_expected_tokens / edge.latency.rate
                ) / (max(parallelism, 1) * self.n_edge)
        wait *= self.memory_pressure_factor()
        # observed edge failure rate inflates the edge-side term: a member
        # that fails with probability q is expected to cost 1/(1-q) runs
        # (retry/hedge), so repeated faults push Eq.(2) past the budget and
        # admission steers back toward cloud_full. At rate 0 (fault-free or
        # no telemetry yet) this is exactly the seed expression.
        fail = min(self.monitor.edge_failure_rate, 0.9)
        return (self.cloud.f(sketch_tokens)
                + self.network.delay_s(sketch_tokens)
                + (c_f_l + wait) / (1.0 - fail))

    def feasible(self, sketch_tokens: int, expected_len: int,
                 edge: EdgeModelInfo, parallelism: int,
                 sla: Optional[SLA] = None) -> bool:
        budget = self.cloud.f(expected_len)           # cloud-only latency
        if sla and sla.max_latency_s:
            budget = min(budget, sla.max_latency_s)
        return self.e2e_latency(sketch_tokens, expected_len, edge,
                                parallelism) <= budget

    def levels(self, expected_len: int) -> List[int]:
        """Sketch-length levels from ~0 to l_i (level 0 = no sketch)."""
        out = [0]
        for i in range(1, self.n_levels):
            out.append(int(round(expected_len * i / self.n_levels)))
        return out

    # -- parallelism estimate -----------------------------------------------
    # The paper sets p=1 as the conservative default; with its own hardware
    # constants (fp16 SLMs on Orin are ~2.3x slower per token than the cloud
    # A100), Eq.(2) is then never satisfiable — so, as a documented
    # strengthening, the scheduler anticipates the execution optimizer's
    # binary-tree merge plan: a sketch of `sk` tokens segments into ~sk/12
    # sentences, merged pairwise into ~sk/24 groups.
    TOKENS_PER_SENTENCE = 12
    max_parallelism: int = 8

    def estimate_parallelism(self, sketch_tokens: int) -> int:
        groups = sketch_tokens // (2 * self.TOKENS_PER_SENTENCE)
        return int(max(1, min(self.max_parallelism, groups)))

    # -- decision -----------------------------------------------------------
    def schedule(self, expected_len: int, sla: Optional[SLA] = None,
                 parallelism: Optional[int] = None) -> ScheduleDecision:
        """Pick (level, SLM) lexicographically: feasibility (hard latency) ->
        error (SLM capability floor on sketch ratio) -> throughput (shortest
        feasible sketch = fewest cloud tokens) -> edge cost."""
        cloud_lat = self.cloud.f(expected_len)
        if not self.admit_progressive(expected_len):
            self.monitor.admission_rejects += 1
            return self._cloud_full_decision(cloud_lat, expected_len)
        options: List[ScheduleDecision] = []
        for name, edge in self.edges.items():
            min_tokens = int(math.ceil(edge.min_sketch_ratio * expected_len))
            for level_idx, sk in enumerate(self.levels(expected_len)):
                if level_idx == 0 or sk < min_tokens:
                    continue
                p = (parallelism if parallelism is not None
                     else self.estimate_parallelism(sk))
                if not self.feasible(sk, expected_len, edge, p, sla):
                    continue
                est = self.e2e_latency(sk, expected_len, edge, p)
                options.append(ScheduleDecision(
                    mode="progressive", sketch_tokens=sk, level=level_idx,
                    edge_model=name, parallelism=p,
                    est_latency_s=est, est_cloud_latency_s=cloud_lat,
                    metrics={
                        "error": 1.0 - edge.capability,
                        "throughput": -1.0 / max(sk, 1),   # fewer cloud tokens
                        "latency": est,
                        "server_cost": float(sk),
                        "edge_cost": float(expected_len),
                    }))
        if not options:
            return self._cloud_full_decision(cloud_lat, expected_len)
        order = sla.metric_order if sla else SLA().metric_order
        return lexicographic_select(options, order)

    @staticmethod
    def _cloud_full_decision(cloud_lat: float,
                             expected_len: int) -> ScheduleDecision:
        return ScheduleDecision(
            mode="cloud_full", est_latency_s=cloud_lat,
            est_cloud_latency_s=cloud_lat,
            metrics={"error": 0.0, "latency": cloud_lat,
                     "server_cost": float(expected_len),
                     "edge_cost": 0.0,
                     "throughput": -1.0 / max(expected_len, 1)})


def lexicographic_select(options: List[ScheduleDecision],
                         order: Sequence[str],
                         tolerance: float = 0.05) -> ScheduleDecision:
    """Multi-objective lexicographic formulation (paper Eq. after (1)):
    minimize metrics in importance order; each earlier metric's achieved
    optimum becomes a constraint (within `tolerance`) for later ones."""
    remaining = list(options)
    for m in order:
        vals = [o.metrics.get(m, 0.0) for o in remaining]
        best = min(vals)
        slack = abs(best) * tolerance + 1e-9
        remaining = [o for o, v in zip(remaining, vals) if v <= best + slack]
        if len(remaining) == 1:
            break
    return remaining[0]
