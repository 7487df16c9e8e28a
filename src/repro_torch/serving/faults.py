"""Deterministic fault injection for the cloud-edge serving stack.

A seeded `FaultPlan` describes WHAT can go wrong — transfer loss/timeout/
bandwidth collapse/partition windows on the `NetworkModel`, and per-step
straggler delays, mid-decode slot crashes, whole-engine crashes, and page-
pool squeezes on an `InferenceEngine`. A `FaultInjector` turns the plan into
the two hook surfaces the serving layer exposes:

  network.fault_hook(n_bytes)  -> None | (kind, param)   per transfer attempt
  engine.step_hook(engine)                               per engine step
  engine.swap_fault_hook(req_id) -> bool                 per swap promote

Determinism contract: every decision is drawn from one seeded PRNG in event
order (transfer index, per-engine step index), never from wall-clock time —
the same plan against the same request stream injects the same faults, so
chaos tests can assert bit-identical survivor output against a fault-free
run. The one wall-clock effect, the straggler's `time.sleep`, changes WHEN
steps happen, not WHICH faults fire.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Optional, Tuple


class EngineCrash(RuntimeError):
    """An injected whole-engine failure: the engine raises out of `step()`
    and the caller is expected to `abort_all()` and degrade."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of a fault scenario (all fields optional)."""
    seed: int = 0
    # -- network transfer faults (per attempt, drawn in transfer order) ----
    transfer_loss_p: float = 0.0          # attempt dropped, pay one RTT
    transfer_timeout_p: float = 0.0       # attempt stalls for timeout_s
    timeout_s: float = 0.25
    bandwidth_collapse_p: float = 0.0     # attempt succeeds at collapsed bw
    bandwidth_collapse_factor: float = 0.1
    # transfer-index windows [(start, end), ...) during which every attempt
    # is lost — a hard network partition
    partition_windows: Tuple[Tuple[int, int], ...] = ()
    # -- engine faults (per-engine step counters) --------------------------
    straggler_steps: Tuple[int, ...] = ()  # steps that stall the engine
    straggler_delay_s: float = 0.0
    crash_steps: Tuple[int, ...] = ()      # steps that crash one active slot
    engine_crash_steps: Tuple[int, ...] = ()   # steps that raise EngineCrash
    pool_squeeze_step: int = -1            # step to steal free pages at
    pool_squeeze_pages: int = 0
    pool_squeeze_duration: int = 4         # steps until pages are returned
    # -- host-tier swap faults ---------------------------------------------
    swap_loss_p: float = 0.0               # promote upload lost -> replay


class FaultInjector:
    """Materializes a `FaultPlan` against network/engine hook points and
    counts every injected event (`events`) for telemetry and assertions."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._transfer_idx = 0
        self._step_idx: dict = {}          # engine name -> steps seen
        self._squeezed: dict = {}          # engine name -> release step
        self.events = collections.Counter()
        self._attached: list = []

    # -- wiring ------------------------------------------------------------
    def attach(self, network=None, engines=()) -> "FaultInjector":
        if network is not None:
            network.fault_hook = self.on_transfer
            self._attached.append(("net", network))
        for eng in engines:
            eng.step_hook = self.on_step
            eng.swap_fault_hook = self.on_swap_upload
            self._attached.append(("eng", eng))
        return self

    def detach(self) -> None:
        for kind, obj in self._attached:
            if kind == "net":
                obj.fault_hook = None
            else:
                obj.step_hook = None
                obj.swap_fault_hook = None
        self._attached.clear()

    # -- network -----------------------------------------------------------
    def on_transfer(self, n_bytes: float) -> Optional[Tuple[str, float]]:
        """Fault verdict for one transfer attempt: None (clean), or
        ("loss"|"timeout"|"collapse", param)."""
        i = self._transfer_idx
        self._transfer_idx += 1
        p = self.plan
        for a, b in p.partition_windows:
            if a <= i < b:
                self.events["partition"] += 1
                return ("loss", 0.0)
        r = self._rng.random()
        if r < p.transfer_loss_p:
            self.events["transfer_loss"] += 1
            return ("loss", 0.0)
        r -= p.transfer_loss_p
        if r < p.transfer_timeout_p:
            self.events["transfer_timeout"] += 1
            return ("timeout", p.timeout_s)
        r -= p.transfer_timeout_p
        if r < p.bandwidth_collapse_p:
            self.events["bandwidth_collapse"] += 1
            return ("collapse", p.bandwidth_collapse_factor)
        return None

    # -- engine ------------------------------------------------------------
    def on_step(self, engine) -> None:
        """Called at the top of `InferenceEngine.step()`."""
        name = engine.name
        i = self._step_idx.get(name, 0)
        self._step_idx[name] = i + 1
        p = self.plan
        if i in p.straggler_steps and p.straggler_delay_s > 0:
            self.events["straggler"] += 1
            time.sleep(p.straggler_delay_s)
        if i == p.pool_squeeze_step and engine.kv_backend == "paged":
            self._squeeze(engine, i)
        rel = self._squeezed.get(name)
        if rel is not None and i >= rel:
            engine.alloc.release(self._hold_key(name))
            del self._squeezed[name]
        if i in p.crash_steps:
            self._crash_slot(engine)
        if i in p.engine_crash_steps:
            self.events["engine_crash"] += 1
            raise EngineCrash(f"injected engine crash on {name} step {i}")

    @staticmethod
    def _hold_key(name: str) -> str:
        return f"__fault_hold__{name}"

    def _squeeze(self, engine, step: int) -> None:
        """Steal free pages (leaving at least one) to simulate pool
        exhaustion; they return to the free list after the squeeze window
        via the allocator's normal release path."""
        alloc = engine.alloc
        n = min(self.plan.pool_squeeze_pages, max(len(alloc.free) - 1, 0))
        if n <= 0:
            return
        held = []
        for _ in range(n):
            p = alloc.free.pop()
            alloc.refcount[p] = 1
            held.append(p)
        alloc.owned[self._hold_key(engine.name)] = held
        self._squeezed[engine.name] = step + self.plan.pool_squeeze_duration
        self.events["pool_squeeze"] += 1

    def _crash_slot(self, engine) -> None:
        """Crash one active slot mid-decode: the lowest-priority, youngest
        request (the same ordering eviction uses) is cancelled."""
        active = [i for i, s in enumerate(engine.slots) if s.active]
        if not active:
            return
        v = min(active, key=lambda i: (engine.slots[i].priority,
                                       -engine.slots[i].arrival))
        engine.cancel(engine.slots[v].req_id)
        self.events["slot_crash"] += 1

    # -- host-tier swap ----------------------------------------------------
    def on_swap_upload(self, req_id) -> bool:
        """True when a swap promote's upload is lost (the engine then drops
        the host snapshot and degrades to evict-and-replay)."""
        if self._rng.random() < self.plan.swap_loss_p:
            self.events["swap_loss"] += 1
            return True
        return False
