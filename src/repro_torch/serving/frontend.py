"""Async multiplexed serving front-end: one shared engine, many streams.

`EngineFrontend` puts a request-handle API on top of ONE `InferenceEngine`
(or one per simulated device tier — the PICE pipeline builds a front-end for
the cloud engine and each edge engine), so every PICE role — cloud sketch,
full cloud answers, N parallel edge expansions, extra ensemble members —
contends for the same slots, pages, priority eviction, and continuous batch
instead of owning an engine:

  submit(CompletionRequest) -> RequestHandle     (stream / await result)
  generate_async / generate_fanout_async         (pipeline facades)
  generate / generate_fanout                     (sync facades, same API as
                                                  the engine they wrap)

Concurrency model — single-threaded asyncio, no threads touch the device:

  * exactly ONE driver coroutine per front-end calls `engine.step()`; it is
    spawned lazily on the running loop and exits when the engine drains
    (a later submit restarts it). All other coroutines only enqueue work
    and await handles.
  * each driver iteration: sweep deadlines -> admit (engine.try_admit, the
    same admission path the synchronous `_run` loop uses) -> step ->
    publish new tokens + settle finished slots -> collect preempted work
    (engine.drain_resumes) -> yield to the loop.
  * the ONLY blocking calls in the async paths are the engine's own step /
    prefill entry points; `time.sleep` and bare device syncs do not belong
    here.

Backpressure rides the paper's own shedding policy: fresh external
submissions wait in a `MultiListQueue` (core/dispatch.py) and a full queue
sheds the longest-expected work; pipeline-internal work (sketch/expansion
facades) and eviction resumes are not sheddable — the PICE layer already
applied its shedding policy before handing them down.

Per-request deadlines ride the engine's cancel machinery: an overdue request is
cancelled through `engine.cancel` (pending-decode commits pruned, survivor
streams bit-identical) and its handle finishes with reason "deadline" and
whatever tokens it produced. TTFT/TPOT/latency are recorded per request
FROM ARRIVAL — queue wait included.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import AsyncIterator, Dict, List, Optional, Tuple

from repro_torch.core.dispatch import MultiListQueue
from repro_torch.serving.engine import EngineRequest, InferenceEngine
from repro_torch.serving.requests import TIER_PRIORITY

# PICE role -> engine priority (eviction order, admission order): the cloud
# sketch is the critical path of every progressive request and full cloud
# answers are the degradation ladder's safety net, so both outrank edge
# expansions; the primary member's expansion outranks opportunistic extra
# ensemble members (see engine._evict_victim).
ROLE_PRIORITY = {
    "sketch": 2,
    "cloud_full": 2,
    "expansion_primary": 1,
    "expansion_extra": 0,
    "generic": 0,
}

_req_ids = itertools.count(1)

# terminal handle states, keyed by finish reason
_REASON_STATE = {
    "stop": "done", "length": "done",
    "cancelled": "cancelled", "deadline": "cancelled",
    "shed": "shed", "error": "failed",
}


@dataclasses.dataclass
class CompletionRequest:
    """OpenAI-style completion request against the front-end, token-level
    (the repo's tokenizer lives a layer above). `deadline_s` is an absolute
    `time.perf_counter` stamp; `arrival_time_s` defaults to submit time and
    anchors TTFT/latency accounting (queue wait included)."""
    prompt: List[int]
    max_tokens: int = 64
    priority: Optional[int] = None       # None: derived from role/tier
    role: str = "generic"                # ROLE_PRIORITY key
    tier: str = "batch"                  # SLA tier name (requests.SLA_TIERS)
    arrival_time_s: Optional[float] = None
    deadline_s: Optional[float] = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))


@dataclasses.dataclass
class TokenDelta:
    """One streamed token (or the terminal marker when `finish_reason` is
    set — its `token` is -1 and carries no content)."""
    req_id: int
    index: int
    token: int
    logprob: float
    finish_reason: str = ""   # "" mid-stream; "stop"|"length"|"cancelled"|
    #                           "deadline"|"shed"|"error" on the final delta


class RequestHandle:
    """Live view of one submitted request: accumulated tokens, stream of
    `TokenDelta`s, terminal state, and arrival-relative timing."""

    def __init__(self, req: CompletionRequest, frontend: "EngineFrontend"):
        self.req = req
        self.state = "queued"   # queued|running|evicted|done|cancelled|shed|failed
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.finish_reason = ""
        self.error: Optional[BaseException] = None
        self.first_token_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        self._frontend = frontend
        self._queued = None               # the _Queued entry while waiting
        self._deltas: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()

    # -- arrival-relative timing (queue wait included) -------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.req.arrival_time_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.req.arrival_time_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if (self.finish_s is None or self.first_token_s is None
                or len(self.tokens) < 2):
            return None
        return (self.finish_s - self.first_token_s) / (len(self.tokens) - 1)

    def cancel(self) -> bool:
        return self._frontend.cancel(self)

    async def stream(self) -> AsyncIterator[TokenDelta]:
        """Yield `TokenDelta`s as the engine commits them; the final delta
        carries `finish_reason` and ends the iterator."""
        self._frontend._ensure_driver()
        while True:
            d = await self._deltas.get()
            yield d
            if d.finish_reason:
                return

    async def wait(self) -> "RequestHandle":
        """Await completion WITHOUT raising — callers inspect `state`,
        `finish_reason`, and `error` (the load generator's path, where a
        failed request is a data point, not an exception)."""
        self._frontend._ensure_driver()
        await self._done.wait()
        return self

    async def result(self) -> Tuple[List[int], List[float]]:
        """Await completion; returns (tokens, logprobs) — partial when the
        request was cancelled/deadlined, raising the failure (EngineCrash,
        MemoryError) when it errored, so facade callers see exactly the
        exceptions `InferenceEngine.generate` raises."""
        self._frontend._ensure_driver()
        await self._done.wait()
        if self.error is not None:
            raise self.error
        return list(self.tokens), list(self.logprobs)


class _Queued:
    """A waiting-room entry: the handle plus the `EngineRequest` admission
    will hand to `engine.try_admit`. `expected_length` is what the
    MultiListQueue buckets/sheds on."""

    def __init__(self, handle: RequestHandle, work: EngineRequest):
        self.handle = handle
        self.work = work
        self.expected_length = handle.req.max_tokens


class EngineFrontend:
    """One multiplexed `InferenceEngine` behind an async streaming API.

    Engine attributes (telemetry, fault hooks) forward transparently:
    `RuntimeMonitor.observe_engines` and `FaultInjector.attach` address a
    front-end exactly like the engine it wraps — in particular a
    `FaultPlan`'s `step_hook`/`swap_fault_hook` assignments land on the
    engine."""

    def __init__(self, engine: InferenceEngine, monitor=None,
                 queue_max: int = 64,
                 queue_boundaries=(64, 128, 256, 512, 1024)):
        self.engine = engine
        self.monitor = monitor
        self.queue = MultiListQueue(boundaries=queue_boundaries,
                                    max_size=queue_max, monitor=monitor,
                                    on_shed_task=self._on_shed)
        self._lane: List[_Queued] = []          # non-sheddable submissions
        self._resumes: List[EngineRequest] = []  # preempted, awaiting re-admit
        self._live: Dict[int, RequestHandle] = {}
        self._slot_of: Dict[int, int] = {}
        self._driver: Optional[asyncio.Task] = None
        # request-outcome telemetry
        self.completed = 0
        self.shed = 0
        self.cancelled = 0
        self.failed = 0
        self.admit_failures = 0
        self.dropped_resumes = 0

    # -- engine forwarding ------------------------------------------------
    @property
    def step_hook(self):
        return self.engine.step_hook

    @step_hook.setter
    def step_hook(self, fn):
        self.engine.step_hook = fn

    @property
    def swap_fault_hook(self):
        return self.engine.swap_fault_hook

    @swap_fault_hook.setter
    def swap_fault_hook(self, fn):
        self.engine.swap_fault_hook = fn

    def __getattr__(self, item):
        # telemetry/config reads (name, ttft, memory_stats, consume_window,
        # page_size, eos_id, ...) resolve on the wrapped engine
        return getattr(self.engine, item)

    def abort_all(self) -> int:
        """Scrub the engine AND settle every live handle as cancelled (the
        crash-recovery contract `PICEPipeline` relies on)."""
        n = self.engine.abort_all()
        for rid, h in list(self._live.items()):
            self._detach(rid)
            self._finish(h, "cancelled")
        for r in list(self._resumes):
            if r.swap is not None:
                self.engine.alloc.drop_hosted(r.req_id)
        self._resumes.clear()
        return n

    # -- submission -------------------------------------------------------
    def submit(self, req: CompletionRequest,
               sheddable: bool = True) -> RequestHandle:
        """Enqueue a request; returns immediately with its handle. With
        `sheddable` (external ingress — the load generator path) the request
        waits in the MultiListQueue and may be shed under backpressure;
        pipeline-internal facades submit non-sheddable."""
        if req.priority is None:
            req.priority = max(ROLE_PRIORITY.get(req.role, 0),
                               TIER_PRIORITY.get(req.tier, 0))
        work = EngineRequest(req_id=req.req_id, prompt=list(req.prompt),
                             max_new=req.max_tokens, carry_tokens=[],
                             carry_lps=[], priority=req.priority)
        return self._enqueue(req, work, sheddable)

    def stream(self, req: CompletionRequest,
               sheddable: bool = True) -> AsyncIterator[TokenDelta]:
        """submit() and stream the deltas (`submit(request) ->
        AsyncIterator[token_delta]` in one call)."""
        return self.submit(req, sheddable=sheddable).stream()

    def _enqueue(self, req: CompletionRequest, work: EngineRequest,
                 sheddable: bool) -> RequestHandle:
        if req.arrival_time_s is None:   # fanout forks enqueue directly
            req.arrival_time_s = time.perf_counter()
        h = RequestHandle(req, self)
        q = _Queued(h, work)
        h._queued = q
        if sheddable:
            if not self.queue.push(q):
                self._finish(h, "shed")
                return h
        else:
            self._lane.append(q)
        self._ensure_driver()
        return h

    def _on_shed(self, q: "_Queued") -> None:
        """MultiListQueue displaced a queued request to admit a shorter one."""
        self._finish(q.handle, "shed")

    # -- cancellation / deadlines ----------------------------------------
    def cancel(self, handle: RequestHandle, reason: str = "cancelled") -> bool:
        """Cancel a request in any live state: still queued, running,
        evicted-and-waiting, or demoted to the host tier. The handle
        finishes with `reason` and every token committed so far."""
        if handle.state in ("done", "cancelled", "shed", "failed"):
            return False
        rid = handle.req.req_id
        if reason == "deadline":
            self.engine.deadline_cancels += 1
        if handle.state == "queued":
            q = handle._queued
            if q in self._lane:
                self._lane.remove(q)
            else:
                self.queue.remove(q)
            self._finish(handle, reason)
            return True
        # running / evicted: engine.cancel prunes the slot, the engine's
        # resume queue, any pending-decode commit, and host-tier snapshots
        self.engine.cancel(rid)
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            s = self.engine.slots[slot]
            self._emit_new(handle, s.tokens, s.logprobs)
            s.req_id = -1
        self._drop_resume(rid, handle)
        self._live.pop(rid, None)
        self.engine._inflight.discard(rid)
        self._finish(handle, reason)
        return True

    def _sweep_deadlines(self, now: float) -> None:
        waiting = list(self._lane) + [t for lst in self.queue.lists
                                      for t in lst]
        for q in waiting:
            dl = q.handle.req.deadline_s
            if dl is not None and now > dl:
                self.cancel(q.handle, reason="deadline")
        for h in list(self._live.values()):
            dl = h.req.deadline_s
            if dl is not None and now > dl:
                self.cancel(h, reason="deadline")

    def _drop_resume(self, rid: int,
                     handle: Optional[RequestHandle] = None) -> None:
        r = next((x for x in self._resumes if x.req_id == rid), None)
        if r is None:
            return
        self._resumes.remove(r)
        if r.swap is not None:
            self.engine.alloc.drop_hosted(rid)
        if handle is not None:
            # a token committed at the pre-eviction harvest may not have
            # been published yet: the carried prefix is the source of truth
            self._emit_new(handle, r.carry_tokens, r.carry_lps)

    # -- driver -----------------------------------------------------------
    def _ensure_driver(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        # repro-analysis: disable=RA501 reason=no running loop is the sync-facade path, not a fault; the facade drives via asyncio.run
        except RuntimeError:
            # no running loop: the sync facade drives via asyncio.run
            return
        if self._driver is None or self._driver.done():
            self._driver = loop.create_task(self._drive())

    def _has_work(self) -> bool:
        return bool(self._slot_of or self._resumes or self._lane
                    or len(self.queue))

    async def _drive(self) -> None:
        """THE step loop: the only coroutine that touches the engine's
        device state. Exits when the front-end drains (a later submit
        re-spawns it)."""
        engine = self.engine
        try:
            while True:
                self._sweep_deadlines(time.perf_counter())
                try:
                    self._admit()
                    if any(s.active for s in engine.slots):
                        engine.step()
                except Exception as exc:   # EngineCrash, or any step fault
                    self.on_crash(exc)
                self._publish_and_settle()
                for r in engine.drain_resumes():
                    if r.req_id in self._live:
                        self._live[r.req_id].state = "evicted"
                        self._resumes.append(r)
                    else:
                        # not ours (cancelled in the same step): drop
                        if r.swap is not None:
                            engine.alloc.drop_hosted(r.req_id)
                        self.dropped_resumes += 1
                if not self._has_work():
                    return
                await asyncio.sleep(0)
        finally:
            self._driver = None

    def on_crash(self, exc: BaseException) -> None:
        """An injected (or real) engine crash mid-step: scrub the engine,
        fail every live handle with the crash so awaiting facade callers
        see the same EngineCrash `engine.generate` would raise, and keep
        serving the still-queued work on the scrubbed engine."""
        self.engine.abort_all()
        for rid, h in list(self._live.items()):
            self._detach(rid)
            self._finish(h, "error", error=exc)
        for r in list(self._resumes):
            if r.swap is not None:
                self.engine.alloc.drop_hosted(r.req_id)
        self._resumes.clear()

    def _detach(self, rid: int) -> None:
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            self.engine.slots[slot].req_id = -1
        self._live.pop(rid, None)
        self.engine._inflight.discard(rid)

    # -- admission --------------------------------------------------------
    def _admission_key(self, q: "_Queued"):
        # higher priority first; FIFO (req_id order) within a priority
        return (-q.work.priority, q.work.req_id)

    def _next_candidate(self) -> Optional["_Queued"]:
        lane = min(self._lane, key=self._admission_key) if self._lane else None
        shed = self.queue.peek_best(self._admission_key)
        if lane is None or shed is None:
            return lane or shed
        return lane if self._admission_key(lane) <= \
            self._admission_key(shed) else shed

    def _admit(self) -> None:
        """Admit work while slots are free: eviction resumes first (FIFO,
        head-of-line blocking — exactly `_run_inner`'s order, so preempted
        work cannot be starved by fresh arrivals), then queued requests in
        (priority, arrival) order through the same `try_admit` path."""
        engine = self.engine
        while engine.free_slots():
            if self._resumes:
                r = self._resumes[0]
                h = self._live.get(r.req_id)
                if h is None:
                    self._resumes.pop(0)
                    self.dropped_resumes += 1
                    continue
                try:
                    slot = engine.try_admit(r)
                except MemoryError as exc:
                    self.admit_failures += 1
                    self._resumes.pop(0)
                    self._detach(r.req_id)
                    self._finish(h, "error", error=exc)
                    continue
                if slot is None:
                    return               # head-of-line waits for pages
                self._resumes.pop(0)
                self._slot_of[r.req_id] = slot
                h.state = "running"
                continue
            q = self._next_candidate()
            if q is None:
                return
            try:
                slot = engine.try_admit(q.work)
            except MemoryError as exc:
                self.admit_failures += 1
                self._remove_queued(q)
                self._finish(q.handle, "error", error=exc)
                continue
            if slot is None:
                return
            self._remove_queued(q)
            rid = q.work.req_id
            self._live[rid] = q.handle
            self._slot_of[rid] = slot
            engine._inflight.add(rid)
            q.handle.state = "running"

    def _remove_queued(self, q: "_Queued") -> None:
        if q in self._lane:
            self._lane.remove(q)
        else:
            self.queue.remove(q)

    # -- publish / settle -------------------------------------------------
    def _emit_new(self, h: RequestHandle, tokens: List[int],
                  lps: List[float]) -> None:
        for i in range(len(h.tokens), len(tokens)):
            self._emit(h, tokens[i], lps[i])

    def _emit(self, h: RequestHandle, tok: int, lp: float) -> None:
        idx = len(h.tokens)
        h.tokens.append(tok)
        h.logprobs.append(lp)
        if h.first_token_s is None:
            h.first_token_s = time.perf_counter()
            if self.monitor is not None:
                self.monitor.record_ttft(h.ttft_s)
        h._deltas.put_nowait(TokenDelta(h.req.req_id, idx, tok, lp))

    def _publish_and_settle(self) -> None:
        """Publish newly committed tokens as deltas and settle released
        slots. Runs right after step() in the same iteration, before any
        other coroutine can run, so a slot the engine released cannot be
        reused (admission and prefix parking happen at later yield points)
        before its final tokens are published."""
        engine = self.engine
        for rid, slot in list(self._slot_of.items()):
            h = self._live[rid]
            s = engine.slots[slot]
            self._emit_new(h, s.tokens, s.logprobs)
            if s.active:
                continue
            del self._slot_of[rid]
            if s.evicted:
                s.evicted = False
                h.state = "evicted"   # its resume is drained right after
                continue
            s.req_id = -1
            del self._live[rid]
            engine._inflight.discard(rid)
            if h.tokens and h.tokens[-1] == engine.eos_id:
                reason = "stop"
            elif s.generated >= s.max_new or s.ctx_len >= engine.max_len:
                reason = "length"
            else:
                # cancelled out from under us (e.g. an injected fault's
                # cancel mode): partial tokens, like engine._run returns
                reason = "cancelled"
            self._finish(h, reason)

    def _finish(self, h: RequestHandle, reason: str,
                error: Optional[BaseException] = None) -> None:
        h.state = _REASON_STATE[reason]
        h.finish_reason = reason
        h.error = error
        h.finish_s = time.perf_counter()
        if reason in ("stop", "length"):
            self.completed += 1
        elif reason == "shed":
            self.shed += 1
        elif reason == "error":
            self.failed += 1
        else:
            self.cancelled += 1
        if self.monitor is not None and reason not in ("shed", "error"):
            self.monitor.record_latency(h.latency_s)
        h._deltas.put_nowait(TokenDelta(h.req.req_id, len(h.tokens), -1, 0.0,
                                        finish_reason=reason))
        h._done.set()

    # -- pipeline facades -------------------------------------------------
    async def generate_async(self, prompts: List[List[int]],
                             max_new: int = 128,
                             priorities: Optional[List[int]] = None,
                             deadline_s: Optional[float] = None,
                             role: str = "generic"
                             ) -> List[Tuple[List[int], List[float]]]:
        """`InferenceEngine.generate` semantics over the multiplexed
        front-end: same results/ordering, same MemoryError/EngineCrash
        behavior, deadline-cancelled requests return partials."""
        if priorities is None:
            priorities = [None] * len(prompts)   # derive from role/tier
        assert len(priorities) == len(prompts), \
            "priorities must match prompts one-to-one"
        handles = [self.submit(
            CompletionRequest(prompt=list(p), max_tokens=max_new,
                              priority=pr, role=role, deadline_s=deadline_s),
            sheddable=False)
            for p, pr in zip(prompts, priorities)]
        return await self._gather(handles)

    async def _gather(self, handles: List[RequestHandle]
                      ) -> List[Tuple[List[int], List[float]]]:
        """Await a facade call's own handles; on failure cancel THIS call's
        surviving siblings (scoped cleanup — co-tenants multiplexed on the
        same engine are untouched) and re-raise."""
        try:
            return [await h.result() for h in handles]
        except Exception:
            for h in handles:
                self.cancel(h)
            raise

    async def generate_fanout_async(self, prefix: List[int],
                                    suffixes: List[List[int]],
                                    max_new: int = 128, priority: int = 0,
                                    deadline_s: Optional[float] = None,
                                    role: str = "expansion_primary"
                                    ) -> List[Tuple[List[int], List[float]]]:
        """`InferenceEngine.generate_fanout` over the front-end: park the
        shared prefix once, submit each suffix as a COW fork request, and
        await all members. Falls back to independent submissions exactly
        where the engine does."""
        engine = self.engine
        if engine.kv_backend != "paged" or engine.max_batch < 2:
            return await self.generate_async(
                [list(prefix) + list(s) for s in suffixes], max_new=max_new,
                priorities=[priority] * len(suffixes), deadline_s=deadline_s,
                role=role)

        def can_park() -> bool:
            # keep >=1 non-parked slot so concurrent fan-outs cannot park
            # the whole batch and deadlock their own forks
            return bool(engine.free_slots()) and sum(
                1 for s in engine.slots if s.parked) < engine.max_batch - 1

        while not can_park():
            self._ensure_driver()
            await asyncio.sleep(0)
        p_slot = engine.prefill_prefix(prefix)
        handles = []
        try:
            for sfx in suffixes:
                req = CompletionRequest(prompt=list(prefix) + list(sfx),
                                        max_tokens=max_new, priority=priority,
                                        role=role, deadline_s=deadline_s)
                work = EngineRequest(
                    req_id=req.req_id, prompt=list(req.prompt),
                    max_new=max_new, carry_tokens=[], carry_lps=[],
                    share_from=p_slot, suffix=list(sfx), priority=priority)
                handles.append(self._enqueue(req, work, sheddable=False))
            return await self._gather(handles)
        finally:
            engine.release_prefix(p_slot)

    def generate(self, prompts: List[List[int]], max_new: int = 128,
                 priorities: Optional[List[int]] = None,
                 deadline_s: Optional[float] = None
                 ) -> List[Tuple[List[int], List[float]]]:
        """Sync facade (drop-in for `InferenceEngine.generate`): runs the
        event loop to completion. Not callable from inside a running loop —
        use `generate_async` there."""
        return asyncio.run(self.generate_async(
            prompts, max_new=max_new, priorities=priorities,
            deadline_s=deadline_s))

    def generate_fanout(self, prefix: List[int], suffixes: List[List[int]],
                        max_new: int = 128, priority: int = 0,
                        deadline_s: Optional[float] = None
                        ) -> List[Tuple[List[int], List[float]]]:
        """Sync facade for `generate_fanout_async`."""
        return asyncio.run(self.generate_fanout_async(
            prefix, suffixes, max_new=max_new, priority=priority,
            deadline_s=deadline_s))

    async def drain(self) -> None:
        """Wait until every submitted request has settled."""
        while self._has_work():
            self._ensure_driver()
            await asyncio.sleep(0)


def as_frontend(engine, monitor=None, queue_max: int = 64
                ) -> Optional[EngineFrontend]:
    """Wrap a raw `InferenceEngine` in an `EngineFrontend`; `None` and
    already-wrapped engines pass through (the PICE pipeline auto-wraps
    whatever it is constructed with, so callers can hand it raw engines or
    pre-shared front-ends interchangeably)."""
    if engine is None or isinstance(engine, EngineFrontend):
        return engine
    return EngineFrontend(engine, monitor=monitor, queue_max=queue_max)
