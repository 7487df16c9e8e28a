"""Trace-driven load generator for the serving front-end.

Two trace sources, one replay path:

  * `synthesize_trace(...)` — seeded Poisson process: exponential
    inter-arrival gaps at `rate_rps`, per-request prompt length / decode
    budget / SLA tier drawn from the same seeded stream, so a (seed, rate)
    pair names ONE reproducible workload.
  * `load_trace(path)` / `save_trace(path, trace)` — JSONL, one
    `{"arrival_s": ..., "prompt_len": ..., "max_new": ..., "tier": ...}`
    object per line, for replaying captured or hand-built workloads.

`replay(frontend, trace, ...)` submits each entry at its arrival offset
(real `asyncio.sleep` between arrivals — the engine keeps stepping
concurrently on the step-loop coroutine) with a tier-derived deadline,
awaits every handle without raising, and folds the outcomes into a
`LoadReport`: goodput (tokens/s from requests that finished within their
SLA), total throughput, SLA attainment per tier, and arrival-relative
TTFT/latency percentiles. `sweep(...)` replays the same seeded workload
shape at several offered loads — the goodput-vs-offered-load and
SLA-attainment curves.

Token content is bit-reproducible (prompts derive from (seed, index)
alone); timing metrics are wall-clock and therefore host-dependent.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.frontend import CompletionRequest, EngineFrontend
from repro_torch.serving.requests import SLA_TIERS

# default tier mix for synthetic traces (weights, not probabilities)
DEFAULT_TIER_MIX = {"interactive": 0.25, "standard": 0.5, "batch": 0.25}


@dataclasses.dataclass
class TraceEntry:
    """One request in a workload trace: WHEN it arrives (seconds from trace
    start), its shape, and which SLA tier it bought."""
    arrival_s: float
    prompt_len: int
    max_new: int
    tier: str = "standard"


def synthesize_trace(rate_rps: float, n: int, seed: int = 0,
                     prompt_len: tuple = (4, 24),
                     max_new: tuple = (8, 48),
                     tier_mix: Optional[Dict[str, float]] = None
                     ) -> List[TraceEntry]:
    """Seeded Poisson workload: `n` requests at offered load `rate_rps`."""
    rng = random.Random(seed)
    mix = tier_mix or DEFAULT_TIER_MIX
    tiers = list(mix)
    weights = [mix[t] for t in tiers]
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(TraceEntry(
            arrival_s=t,
            prompt_len=rng.randint(*prompt_len),
            max_new=rng.randint(*max_new),
            tier=rng.choices(tiers, weights=weights)[0]))
    return out


def save_trace(path: str, trace: Sequence[TraceEntry]) -> None:
    with open(path, "w") as f:
        for e in trace:
            f.write(json.dumps(dataclasses.asdict(e)) + "\n")


def load_trace(path: str) -> List[TraceEntry]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceEntry(**json.loads(line)))
    return out


def trace_prompt(seed: int, index: int, prompt_len: int,
                 vocab_size: int) -> List[int]:
    """The bit-reproducible prompt for trace entry `index`: a function of
    (seed, index) only, so isolated-vs-multiplexed comparisons can rebuild
    the exact token stream."""
    rng = random.Random(seed * 1000003 + index)
    return [rng.randrange(1, max(vocab_size - 1, 2))
            for _ in range(max(prompt_len, 1))]


@dataclasses.dataclass
class LoadReport:
    """Outcome of one trace replay at one offered load."""
    offered_rps: float
    n_requests: int
    elapsed_s: float
    completed: int = 0
    shed: int = 0
    deadline_cancelled: int = 0
    failed: int = 0
    good_tokens: int = 0          # tokens from requests that met their SLA
    total_tokens: int = 0
    sla_met: int = 0
    sla_eligible: int = 0         # completed-or-cancelled, i.e. not shed/failed
    per_tier_met: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_tier_total: Dict[str, int] = dataclasses.field(default_factory=dict)
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0

    @property
    def goodput_tps(self) -> float:
        """Tokens/s from requests that finished within their SLA — the
        paper-facing serving metric (shed/deadline-blown work produces
        tokens but no goodput)."""
        return self.good_tokens / max(self.elapsed_s, 1e-9)

    @property
    def throughput_tps(self) -> float:
        return self.total_tokens / max(self.elapsed_s, 1e-9)

    @property
    def sla_attainment(self) -> float:
        """Fraction of non-shed requests that met their tier's deadline
        (batch tier: completing at all meets it)."""
        if self.sla_eligible <= 0:
            return 0.0
        return self.sla_met / self.sla_eligible

    def summary(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["goodput_tps"] = self.goodput_tps
        d["throughput_tps"] = self.throughput_tps
        d["sla_attainment"] = self.sla_attainment
        return d


async def replay(frontend: EngineFrontend, trace: Sequence[TraceEntry],
                 seed: int = 0, time_scale: float = 1.0,
                 tier_budget_s: float = 1.0,
                 offered_rps: float = 0.0) -> LoadReport:
    """Replay `trace` against `frontend` in (scaled) real time.

    `time_scale` compresses arrival gaps (0.5 = twice the offered load of
    the recorded trace); `tier_budget_s` converts the relative SLA tier
    budgets (requests.SLA_TIERS) into seconds of end-to-end deadline,
    measured from arrival. Requests are submitted sheddable — backpressure
    sheds exactly as the MultiListQueue policy dictates."""
    vocab = frontend.engine.cfg.vocab_size
    t0 = time.perf_counter()
    handles = []
    for i, e in enumerate(trace):
        target = t0 + e.arrival_s * time_scale
        delay = target - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        now = time.perf_counter()
        budget = SLA_TIERS.get(e.tier)
        deadline = None if budget is None else now + budget * tier_budget_s
        req = CompletionRequest(
            prompt=trace_prompt(seed, i, e.prompt_len, vocab),
            max_tokens=e.max_new, tier=e.tier,
            arrival_time_s=now, deadline_s=deadline)
        handles.append((e, frontend.submit(req)))
    for _, h in handles:
        await h.wait()
    report = LoadReport(offered_rps=offered_rps, n_requests=len(trace),
                        elapsed_s=time.perf_counter() - t0)
    for e, h in handles:
        report.per_tier_total[e.tier] = report.per_tier_total.get(e.tier,
                                                                  0) + 1
        n_toks = len(h.tokens)
        report.total_tokens += n_toks
        if h.state == "shed":
            report.shed += 1
            continue
        if h.state == "failed":
            report.failed += 1
            continue
        report.sla_eligible += 1
        if h.finish_reason == "deadline":
            report.deadline_cancelled += 1
            continue                      # blew its budget: no goodput
        report.completed += 1
        report.sla_met += 1
        report.good_tokens += n_toks
        report.per_tier_met[e.tier] = report.per_tier_met.get(e.tier, 0) + 1
    mon = frontend.monitor
    if mon is not None:
        report.ttft_p50_s = mon.ttft_percentile(50)
        report.ttft_p95_s = mon.ttft_percentile(95)
        report.latency_p50_s = mon.latency_percentile(50)
        report.latency_p95_s = mon.latency_percentile(95)
    return report


def replay_sync(frontend: EngineFrontend, trace: Sequence[TraceEntry],
                **kw) -> LoadReport:
    """Sync wrapper: drive the replay to completion on a fresh loop."""
    return asyncio.run(replay(frontend, trace, **kw))


def sweep(frontend_factory, base_rate_rps: float, n_requests: int,
          load_multipliers: Sequence[float] = (1.0, 2.0, 4.0),
          seed: int = 0, tier_budget_s: float = 1.0,
          prompt_len: tuple = (4, 24), max_new: tuple = (8, 48)
          ) -> List[LoadReport]:
    """Replay the SAME seeded workload shape at several offered loads (a
    fresh front-end per point, from `frontend_factory()`), yielding the
    goodput-vs-offered-load / SLA-attainment curves."""
    reports = []
    for m in load_multipliers:
        rate = base_rate_rps * m
        trace = synthesize_trace(rate, n_requests, seed=seed,
                                 prompt_len=prompt_len, max_new=max_new)
        fe = frontend_factory()
        reports.append(replay_sync(fe, trace, seed=seed,
                                   tier_budget_s=tier_budget_s,
                                   offered_rps=rate))
    return reports
