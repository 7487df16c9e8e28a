"""Profiler (paper §III): offline latency estimation + runtime monitoring.

Offline phase fits the latency function f(l) = t0 + l / rate for every
(model, device) pair — either by *measuring* a real InferenceEngine (tiny
models on this host) or from the paper's published hardware calibration
(Table I speeds on A100, Table II cloud/edge specs). The cost coefficient c
is the ratio of edge-SLM to cloud-LLM per-token time (paper §IV-A-1).

Runtime phase tracks queue depth, in-flight work, and network state for the
scheduler's Eq. (2) feasibility checks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np

from repro_torch.serving.requests import BoundedRecord


@dataclasses.dataclass
class LatencyModel:
    """f(l) = t0 + l / rate  (seconds for a response of l tokens)."""
    t0: float
    rate: float                   # tokens / second
    name: str = ""

    def f(self, l: float) -> float:
        return self.t0 + max(l, 0.0) / self.rate


# Paper Table I: tokens/s on 2xA100 with vLLM; MMLU as capability proxy.
PAPER_CLOUD_SPEEDS = {
    "qwen2.5-72b": (18.19, 86.1),
    "llama3-70b": (18.82, 79.5),
    "qwen2.5-32b": (22.13, 83.3),
    "llama3-8b": (76.5, 66.6),
    "qwen2.5-7b": (84.28, 74.2),
    "qwen2.5-1.5b": (183.33, 60.9),
}

# Table II: decode is HBM-bandwidth-bound, so edge/cloud per-token time scales
# with the bandwidth ratio (Jetson AGX Orin 204.8 GB/s vs A100 1935 GB/s).
# The paper's edge engine is fp16 PyTorch/Transformers (no quantization) —
# this calibration reproduces its Table III edge-only row (~6 req/min, ~800 s
# latency for Llama3-8B on 4 Orins at RPM 30).
EDGE_BW_RATIO = 204.8 / 1935.0
EDGE_QUANT_SPEEDUP = 1.0        # set >1 to model INT-quantized edge weights
PAPER_T0 = 0.5          # request overhead (prefill + framework)


def paper_latency_model(model: str, device: str = "cloud") -> LatencyModel:
    rate, _ = PAPER_CLOUD_SPEEDS[model]
    if device == "edge":
        rate *= EDGE_BW_RATIO * EDGE_QUANT_SPEEDUP
    return LatencyModel(t0=PAPER_T0, rate=rate, name=f"{model}@{device}")


def capability(model: str) -> float:
    """MMLU-derived capability score in (0,1) (paper Table I)."""
    return PAPER_CLOUD_SPEEDS[model][1] / 100.0


def fit_latency_model(samples: List[tuple], name: str = "") -> LatencyModel:
    """Least-squares fit of f(l)=t0+l/rate from (l, seconds) samples."""
    ls = np.asarray([s[0] for s in samples], np.float64)
    ts = np.asarray([s[1] for s in samples], np.float64)
    A = np.stack([np.ones_like(ls), ls], axis=1)
    coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
    t0, slope = float(coef[0]), float(coef[1])
    slope = max(slope, 1e-6)
    return LatencyModel(t0=max(t0, 0.0), rate=1.0 / slope, name=name)


def profile_engine(engine, lengths=(16, 32, 64, 128), prompt=None,
                   name: str = "") -> LatencyModel:
    """Offline-profile a real engine: measure generation time vs length."""
    from repro_torch.data import tokenizer as tok
    prompt = prompt or tok.encode("Q: explain how the system stores tokens works\nA:")
    samples = []
    engine.generate([prompt], max_new=8)          # warmup / compile
    for l in lengths:
        t0 = time.perf_counter()
        engine.generate([prompt], max_new=l)
        samples.append((l, time.perf_counter() - t0))
    return fit_latency_model(samples, name=name or engine.name)


def cost_coefficient(cloud: LatencyModel, edge: LatencyModel,
                     ref_len: int = 256) -> float:
    """c = SLM-at-edge time / LLM-at-cloud time (paper §IV-A-1)."""
    return edge.f(ref_len) / max(cloud.f(ref_len), 1e-9)


@dataclasses.dataclass
class RuntimeMonitor:
    """Runtime telemetry for the scheduler."""
    queue_depth: int = 0
    queued_expected_tokens: float = 0.0
    edge_busy: Dict[str, float] = dataclasses.field(default_factory=dict)
    net_bandwidth_mbps: float = 100.0
    net_rtt_s: float = 0.02
    # engine KV-memory telemetry (paged backend): the scheduler admits work
    # against real page-pool pressure instead of a fixed max_batch.
    # `used` is PHYSICAL occupancy (shared pages counted once); `logical` is
    # what an unshared layout would hold — the gap is the copy-on-write
    # prefix-sharing saving; `shared` is physical pages referenced >1 time.
    kv_pages_total: int = 0
    kv_pages_used: int = 0
    kv_pages_shared: int = 0
    kv_pages_logical: int = 0
    kv_evictions: int = 0
    # tokens one KV page holds (page_size, from observe_engines): converts
    # the length predictor's queued_expected_tokens into a page-count
    # forecast for `kv_predicted_utilization`
    kv_page_tokens: int = 0
    # fault/degradation telemetry (PICE fault model): edge member attempts
    # and failures feed `edge_failure_rate`, which inflates the scheduler's
    # Eq.(2) edge term so repeated faults steer admission back toward cloud
    edge_attempts: int = 0
    edge_failures: int = 0
    net_retries: int = 0
    net_failures: int = 0
    queue_shed: int = 0
    fallback_primaries: int = 0     # unknown-model guard hits (progressive)
    admission_rejects: int = 0      # progressive path refused on forecast
    #                                 KV occupancy (scheduler admission gate)
    degraded: Dict[str, int] = dataclasses.field(default_factory=dict)
    # arrival-relative request telemetry (serving front-end + pipeline):
    # TTFT and end-to-end latency measured FROM ARRIVAL — queue wait
    # included — not from admission. Bounded windows (BoundedRecord) so a
    # long-running fleet keeps the most recent ~4096 samples.
    ttft_window: BoundedRecord = dataclasses.field(
        default_factory=BoundedRecord)
    latency_window: BoundedRecord = dataclasses.field(
        default_factory=BoundedRecord)

    def on_enqueue(self, expected_tokens: float):
        self.queue_depth += 1
        self.queued_expected_tokens += expected_tokens

    def on_dequeue(self, expected_tokens: float):
        self.queue_depth = max(0, self.queue_depth - 1)
        self.queued_expected_tokens = max(
            0.0, self.queued_expected_tokens - expected_tokens)

    def on_shed(self, expected_tokens: float):
        """A queue admission was refused (or a queued task dropped) because
        the dispatch queue hit max_size. Counts only — depth bookkeeping
        stays with on_enqueue/on_dequeue, which shed tasks never reached."""
        del expected_tokens
        self.queue_shed += 1

    def record_edge_result(self, ok: bool):
        """One ensemble-member expansion attempt finished (ok) or faulted/
        timed out (not ok)."""
        self.edge_attempts += 1
        if not ok:
            self.edge_failures += 1

    def record_transfer(self, ok: bool, attempts: int):
        """Account a `transfer_with_retry` outcome."""
        self.net_retries += max(attempts - 1, 0)
        if not ok:
            self.net_failures += 1

    def record_degraded(self, mode: str):
        """A request landed on a degradation rung (see Response.degraded)."""
        self.degraded[mode] = self.degraded.get(mode, 0) + 1

    def record_ttft(self, ttft_s: float):
        """First token delivered `ttft_s` seconds after ARRIVAL (the wait in
        the admission queue is part of it — a request that queued 2s and
        decoded its first token in 50ms has TTFT 2.05s, not 0.05s)."""
        self.ttft_window.append(float(ttft_s))

    def record_latency(self, latency_s: float):
        """A request finished `latency_s` seconds after arrival."""
        self.latency_window.append(float(latency_s))

    def ttft_percentile(self, q: float) -> float:
        return self.ttft_window.percentile(q)

    def latency_percentile(self, q: float) -> float:
        return self.latency_window.percentile(q)

    @property
    def edge_failure_rate(self) -> float:
        """Observed fraction of edge expansion attempts that faulted; 0.0
        until any attempt is recorded, so a fault-free fleet reproduces the
        seed scheduler behavior exactly."""
        if self.edge_attempts <= 0:
            return 0.0
        return self.edge_failures / self.edge_attempts

    def update_memory(self, pages_used: int, pages_total: int,
                      evictions: int = 0, pages_shared: int = 0,
                      pages_logical: int = 0):
        self.kv_pages_used = pages_used
        self.kv_pages_total = pages_total
        self.kv_evictions = evictions
        self.kv_pages_shared = pages_shared
        self.kv_pages_logical = max(pages_logical, pages_used)

    def observe_engines(self, engines) -> None:
        """Aggregate KV memory pressure across a fleet of InferenceEngines.

        Uses each engine's windowed peak (`consume_window`) rather than its
        instantaneous occupancy: in the synchronous pipeline pools drain to
        zero between requests, so only the high-water mark since the last
        observation carries signal."""
        used = total = ev = shared = logical = 0
        for eng in engines:
            st = eng.memory_stats()
            if hasattr(eng, "consume_window"):
                w = eng.consume_window()
                used += w["pages"]
                shared += w["shared"]
                logical += w["logical"]
            elif hasattr(eng, "consume_peak"):
                peak = eng.consume_peak()
                used += peak
                logical += peak
            else:
                cur = int(st.get("pages_in_use", 0))
                used += cur
                logical += cur
            total += int(st.get("pages_total", 0))
            ev += int(st.get("evictions", 0))
            ps = int(getattr(eng, "page_size", 0) or 0)
            if ps:
                self.kv_page_tokens = ps
        self.update_memory(used, total, ev, pages_shared=shared,
                           pages_logical=logical)

    @property
    def kv_utilization(self) -> float:
        """Physical pool occupancy — COW sharing lowers this directly."""
        if self.kv_pages_total <= 0:
            return 0.0
        return self.kv_pages_used / self.kv_pages_total

    @property
    def kv_predicted_utilization(self) -> float:
        """Forecast pool occupancy: current physical pages plus the pages
        the queue's *predicted* output lengths will demand (the length
        predictor feeds `queued_expected_tokens` via `on_enqueue`). Equals
        `kv_utilization` exactly when nothing is queued or no page geometry
        has been observed, so callers that gate on it reproduce the
        physical-only behavior in those cases."""
        if self.kv_pages_total <= 0:
            return 0.0
        if self.kv_page_tokens <= 0 or self.queued_expected_tokens <= 0:
            return self.kv_utilization
        forecast = -(-self.queued_expected_tokens // self.kv_page_tokens)
        return min(1.0, (self.kv_pages_used + forecast)
                   / self.kv_pages_total)

    @property
    def kv_shared_fraction(self) -> float:
        """Fraction of used pages referenced by >1 slot. High values mean
        the occupancy is mostly shared prefixes: extra fan-out members are
        nearly free, but single-fork eviction reclaims little."""
        if self.kv_pages_used <= 0:
            return 0.0
        return self.kv_pages_shared / self.kv_pages_used

    @property
    def kv_sharing_savings(self) -> float:
        """1 - physical/logical: how much of the unshared footprint COW
        prefix sharing is currently absorbing."""
        if self.kv_pages_logical <= 0:
            return 0.0
        return 1.0 - self.kv_pages_used / self.kv_pages_logical
