"""Cloud <-> edge network transmission model Δ(r).

The paper transmits only queries and sketches ("a few tens of milliseconds
even at lower bandwidths" — Fig. 14); we model Δ(r) = rtt + bytes/bandwidth
with optional jitter, used both by the scheduler's Eq.(2) check and by the
event-driven simulator.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Tuple


@dataclasses.dataclass
class TransferResult:
    """Outcome of `transfer_with_retry`: modeled latency includes every
    failed attempt's cost plus the backoff waits between attempts."""
    ok: bool
    attempts: int
    latency_s: float
    failure: str = ""              # last fault kind when not ok / degraded


@dataclasses.dataclass
class NetworkModel:
    bandwidth_mbps: float = 100.0
    rtt_s: float = 0.02
    jitter_frac: float = 0.0
    bytes_per_token: float = 4.0
    # fault injection point (serving/faults.py): called once per transfer
    # attempt with the payload size, returns None (clean) or a
    # ("loss"|"timeout"|"collapse", param) verdict
    fault_hook: Optional[Callable[[float], Optional[Tuple[str, float]]]] = None
    # cumulative accounting across transfer_with_retry calls
    transfers: int = 0
    retries: int = 0
    transfer_failures: int = 0
    retry_latency_s: float = 0.0
    _rng: random.Random = dataclasses.field(
        default_factory=lambda: random.Random(0))

    def delay_s(self, n_tokens: int) -> float:
        return self.transfer_s(n_tokens * self.bytes_per_token)

    def transfer_s(self, n_bytes: float) -> float:
        """Modeled one-way transfer time for a raw byte payload — the KV
        swap path prices a demoted request's page bytes with this (the
        swap-vs-replay crossover in docs/serving.md), the token path above
        derives its bytes from a token count."""
        base = self.rtt_s + n_bytes * 8 / (self.bandwidth_mbps * 1e6)
        if self.jitter_frac:
            base *= 1.0 + self._rng.uniform(-self.jitter_frac, self.jitter_frac)
            # jitter models queueing variance on top of physics: a draw with
            # jitter_frac >= 1 must not undercut (or negate) the light-path RTT
            base = max(base, self.rtt_s)
        return base

    def transfer_with_retry(self, n_bytes: float, max_attempts: int = 4,
                            base_backoff_s: float = 0.05,
                            max_backoff_s: float = 1.0) -> TransferResult:
        """Transfer a payload with capped jittered exponential backoff.

        Each attempt consults `fault_hook` (when set): a "loss" costs one
        RTT, a "timeout" costs the injected stall, a bandwidth "collapse"
        succeeds at the collapsed rate; clean attempts cost `transfer_s`.
        Between failed attempts the caller waits base * 2^k (capped at
        `max_backoff_s`) jittered to [0.5x, 1.5x) — the jitter draw comes
        from the model's seeded PRNG, so retry schedules are reproducible.
        All costs are MODELED seconds (nothing sleeps); attempt counts and
        cumulative retry latency accumulate on the model for telemetry."""
        latency = 0.0
        kind = ""
        for attempt in range(1, max(max_attempts, 1) + 1):
            fault = self.fault_hook(n_bytes) if self.fault_hook else None
            if fault is None:
                latency += self.transfer_s(n_bytes)
                self.transfers += 1
                self.retries += attempt - 1
                self.retry_latency_s += latency
                return TransferResult(True, attempt, latency)
            kind, param = fault
            if kind == "collapse":
                # degraded but delivered: pay the collapsed-bandwidth time
                latency += self.rtt_s + n_bytes * 8 / (
                    self.bandwidth_mbps * max(param, 1e-3) * 1e6)
                self.transfers += 1
                self.retries += attempt - 1
                self.retry_latency_s += latency
                return TransferResult(True, attempt, latency, failure=kind)
            latency += param if kind == "timeout" else self.rtt_s
            if attempt <= max_attempts - 1:
                back = min(base_backoff_s * (2.0 ** (attempt - 1)),
                           max_backoff_s)
                latency += back * (0.5 + self._rng.random())
        self.transfers += 1
        self.retries += max(max_attempts, 1) - 1
        self.transfer_failures += 1
        self.retry_latency_s += latency
        return TransferResult(False, max(max_attempts, 1), latency,
                              failure=kind)
